"""Build-on-first-use of the CUDA sources in `moma_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface, under `build/moma_tpu_torch/` at the repository root,
keyed by a hash of the sources and flags; the library is loaded with
ctypes.  No PyTorch headers are included, so a build takes seconds.

Nothing here runs at import time: `load()` is called by a kernel wrapper
the first time it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moma_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# per-source extra flags: the RandAugment kernel must round exactly like
# its plain version, so a*b+c is never contracted into one FMA there
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "randaugment": ("-fmad=false",),
}

_BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then torch's own
    CUDA_HOME discovery; raises when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of moma_tpu_torch are built from source at first use")


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _key(name: str, flags) -> str:
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _flags(name: str):
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, ())


def lib_path(name: str) -> Path:
    """Where the library built from this exact source and flags lives."""
    return BUILD_DIR / f"lib{name}-{_key(name, _flags(name))}.so"


def compile_library(cmd, sources, dest: Path) -> subprocess.CompletedProcess:
    """Run `cmd -o <temporary file> sources` and move the result onto
    `dest` when the compiler succeeds: the library appears whole or not
    at all, and processes that build the same library at once each write
    their own temporary file.  Returns the finished process (stdout and
    stderr as text); a failed build leaves nothing behind."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=dest.parent)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp, *sources], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
    else:
        os.replace(tmp, dest)
    return proc


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (if this exact source is not built yet)
    and load it."""
    flags = _flags(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path_ = lib_path(name)
    if not lib_path_.exists():
        t0 = time.perf_counter()
        cmd = [find_nvcc(), *flags, "-I", str(CSRC)]
        proc = compile_library(cmd, [str(CSRC / f"{name}.cu")], lib_path_)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                f"{' '.join(proc.args)}\n{log}")
        lib_path_.with_suffix(".log").write_text(log)
        _BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(lib_path_))


def build_seconds() -> Dict[str, float]:
    """Wall seconds each library took to compile in this process (absent
    when it was already built)."""
    return dict(_BUILD_SECONDS)


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the built
    library for `name`."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def _kernel_name(mangled: str) -> str:
    """The kernel's name from its mangled entry name (the last component of
    a nested name such as `_ZN<namespace><name>I...`), with its type and
    integer template arguments: `flash_fwd_kernel<float, 128>`,
    `k2_kernel<bf16, 5, 1, 6>`."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group(0)
        pos += len(n)
        name = mangled[pos:pos + int(n)]
        pos += int(n)
    t = re.match(r"I(f|13__nv_bfloat16)((?:Li\d+E)*)E", mangled[pos:])
    if t:
        args = ["float" if t.group(1) == "f" else "bf16"]
        args += re.findall(r"Li(\d+)E", t.group(2))
        name += f"<{', '.join(args)}>"
    return name


def ptxas_report(name: str) -> Dict[str, str]:
    """kernel -> ptxas's line on its registers and spills, from the build
    log of `name` (nvcc runs with -Xptxas -v)."""
    out: Dict[str, str] = {}
    kernel = None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
        elif kernel and ("spill" in line or "registers" in line):
            out[kernel] = (out.get(kernel, "") + " " + line.split(
                ":", 1)[-1].strip()).strip()
    return out


def sass_counts(name: str, opcode: str) -> Dict[str, int]:
    """kernel -> number of `opcode` instructions in the built library's
    machine code (cuobjdump -sass); empty where the toolkit that has nvcc
    has no cuobjdump."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            counts[kernel] = 0
        elif kernel and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        lib.moma_error_string.restype = ctypes.c_char_p
        msg = lib.moma_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"CUDA error {rc} ({msg}) launching {what}")
