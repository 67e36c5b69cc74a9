"""ViT / DeiT: moma_tpu_torch.models.vit against moma_tpu.models.vit on the
CPU, the augreg .npz loader and the position-embedding resize.

The same weights (carried by moma_tpu_torch.interop's ViT name map) and
the same float32 inputs go through both forwards: patch 8, dim 32, depth 2,
2 heads, a 32^2 input.  Tolerances, float32:

- the forward: features and logits within 1e-5 of each tensor's largest
  magnitude (the packages sum in other orders; the LayerNorm variance is
  E[x^2] - E[x]^2 in flax and a two-pass mean in torch);
- the pos-embed resize: 4e-6 of max|ref|, about 30 float32 ulps (both
  resize as jax.image's antialiased bilinear; XLA rounds the weights to
  float32 and sums in float32, the port in float64; 1.26e-6 measured at
  14 -> 24);
- the npz loader: every tensor equal bit for bit but the resized position
  embedding (4e-6), and the loaded forward within 1e-4 of max|logits|: the
  synthetic npz of tests/test_vit.py holds unit-normal weights, so the
  residual stream grows far beyond the unit scale and the float32 sums
  over it drift further.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.models.vit_npz import load_vit_npz as j_load_vit_npz
from moma_tpu.models.vit_npz import resize_pos_embed as j_resize_pos_embed

from moma_tpu_torch.interop import (jax_variables, load_jax_variables,
                                    vit_name_map)
from moma_tpu_torch.models import available_models, create_model
from moma_tpu_torch.models.torch_import import export_state_dict
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.models.vit_npz import load_vit_npz, resize_pos_embed

from test_vit import _fake_augreg_npz
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (make_init_ordered, ordered_numpy, quick_jit,
                                walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_CLS = 5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def small_vit():
    jm = JViT(patch_size=8, dim=32, depth=2, num_heads=2, num_classes=N_CLS)
    v = make_init_ordered(jm, (2, 32, 32, 3))(jax.random.PRNGKey(0))
    tm = VisionTransformer(8, 32, 2, 2, N_CLS, image_size=32)
    load_jax_variables(tm, v)
    return jm, v, tm


def test_vit_forward_matches_jax(small_vit):
    jm, v, tm = small_vit
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    (g, c), logits = quick_jit(lambda v, x: jm.apply(v, x))(v, x)
    (tg, tc), tl = tm(torch.from_numpy(x))
    assert tg.shape == (3, 4, 4, 32) and tc.dtype == torch.float32
    assert tm.feat_dim == 32
    for name, got, want in (("grid", tg, g), ("cls", tc, c),
                            ("logits", tl, logits)):
        assert _rel(got.detach().numpy(), want) <= 1e-5, name


def test_vit_weights_cross_both_ways(small_vit):
    """JAX -> port -> JAX gives the same tree, every leaf bit for bit; a
    tree with a leaf the map lacks, or short of one, raises."""
    _, v, tm = small_vit
    back = jax_variables(tm, v)
    n = 0
    for path, got, want in walk_pairs(back, v):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    assert n == len(vit_name_map(2)) == len(tm.state_dict())
    extra = ordered_numpy(v)
    extra["params"]["Block_0"]["extra"] = {"bias": np.zeros(3)}
    with pytest.raises(ValueError, match="unmapped"):
        load_jax_variables(tm, extra)
    short = ordered_numpy(v)
    del short["params"]["pos_embed"]
    with pytest.raises(ValueError, match="not in the JAX tree"):
        load_jax_variables(tm, short)
    # the stream converter keeps refusing ViTs: cls_token / pos_embed
    # have no stream
    with pytest.raises(ValueError, match="npz path"):
        export_state_dict(v, {k: t.numpy() for k, t in
                              tm.state_dict().items()})


def test_registry_holds_the_vit_family():
    names = [n for n in available_models() if n.startswith(("vit", "deit"))]
    assert len(names) == 12 and "vit_small_patch16_224" in names
    assert not any("moe" in n for n in available_models())
    m = create_model("vit_timm_tiny_patch16_224", N_CLS, image_size=48)
    assert m.pos_embed.shape == (1, 10, 192) and len(m.blocks) == 12
    with pytest.raises(ValueError, match="image_size"):
        create_model("deit_small_patch16_224", N_CLS)
    with pytest.raises(ValueError, match="position embedding holds 9"):
        m(torch.zeros(1, 64, 64, 3))


@pytest.mark.parametrize("old,new", [(4, 2), (2, 3), (14, 24)])
def test_resize_pos_embed_matches_jax(old, new):
    pos = np.random.RandomState(old).randn(1, old * old + 1, 16).astype(
        np.float32)
    want = j_resize_pos_embed(pos, new * new + 1)
    got = resize_pos_embed(pos, new * new + 1)
    assert got.shape == want.shape == (1, new * new + 1, 16)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])
    assert _rel(got, want) <= 4e-6


def test_vit_npz_loads_as_in_jax(tmp_path):
    # tests/test_vit.py's synthetic npz at 2 blocks of width 48 (its 3
    # heads), checkpoint grid 4x4 into a model grid of 2x2
    path, w = _fake_augreg_npz(tmp_path, dim=48, depth=2, grid=4)
    jm = JViT(patch_size=16, dim=48, depth=2, num_heads=3, num_classes=7)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    v = make_init_ordered(jm, (1, 32, 32, 3))(jax.random.PRNGKey(0))
    v = j_load_vit_npz(v, path)
    tm = VisionTransformer(16, 48, 2, 3, 7, image_size=32)
    load_vit_npz(tm, path)
    got = jax_variables(tm, v)
    for p, g, want in walk_pairs(got, jax.device_get(v)):
        if p.endswith("pos_embed"):
            assert _rel(g, want) <= 4e-6, p
        else:
            np.testing.assert_array_equal(g, np.asarray(want), err_msg=p)
    _, want = quick_jit(lambda v, x: jm.apply(v, x))(
        jax.tree_util.tree_map(jnp.asarray, v), x)
    _, logits = tm(torch.from_numpy(x))
    assert _rel(logits.detach().numpy(), want) <= 1e-4


def test_vit_pretrained_takes_a_port_checkpoint_not_a_torch_file(tmp_path):
    """--std_pre / --tec_pre for a ViT: a checkpoint of this package (its
    student) loads, with no BN statistics to restore; a torch state-dict
    file is refused, as in the JAX package (no stream holds cls_token /
    pos_embed)."""
    from moma_tpu_torch.models.pretrained import load_pretrained

    src = VisionTransformer(8, 32, 2, 2, N_CLS, image_size=32,
                            generator=torch.Generator().manual_seed(1))
    dst = VisionTransformer(8, 32, 2, 2, N_CLS, image_size=32)
    torch.save({"student": src.state_dict()}, tmp_path / "best_acc.pt")
    load_pretrained(dst, str(tmp_path / "best_acc.pt"))
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    torch.save(src.state_dict(), tmp_path / "vit.pth")
    with pytest.raises(ValueError, match="cannot be aligned to a ViT"):
        load_pretrained(dst, str(tmp_path / "vit.pth"))

