"""moma_tpu_torch.data.augment's crop and resizes against moma_tpu's.

`random_resized_crop_from_draws` takes the four per-image draws that
moma_tpu.data.augment.random_resized_crop makes from its key: the test
makes them with the JAX function's own `jax.random.split(rng, 4)` and
`jax.random.uniform` calls and passes them in, so both sides crop the same
boxes.  Images hold integer values 0..255; tolerance atol 1e-3 on those
values (the two packages take the same float32 products, which differ only
in the order of their sums).  `resize_bilinear` (antialiased when it
shrinks, as jax.image.resize is) at atol 1e-3, `center_crop` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.data import augment as JA
from moma_tpu_torch.data import augment as TA

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-3


def _jax_draws(rng, B, scale, ratio=(3 / 4, 4 / 3)):
    """The draws of moma_tpu.data.augment.random_resized_crop (:92-104)."""
    k_area, k_ratio, k_i, k_j = jax.random.split(rng, 4)
    area_frac = jax.random.uniform(k_area, (B,), minval=scale[0],
                                   maxval=scale[1])
    log_ratio = jax.random.uniform(k_ratio, (B,), minval=jnp.log(ratio[0]),
                                   maxval=jnp.log(ratio[1]))
    u_i = jax.random.uniform(k_i, (B,))
    u_j = jax.random.uniform(k_j, (B,))
    return [torch.from_numpy(np.array(v)) for v in
            (area_frac, log_ratio, u_i, u_j)]


@pytest.mark.parametrize("shape,out,scale,seed", [
    ((4, 64, 64, 3), 64, (0.2, 1.0), 0),
    ((4, 64, 64, 3), 48, (0.08, 1.0), 1),
    ((3, 48, 48, 3), 48, (0.5, 1.0), 2),
    ((3, 40, 56, 3), 24, (0.2, 1.0), 3),     # non-square, shrinks
], ids=["crop0.2", "crop0.08-shrink", "crop0.5", "nonsquare-shrink"])
def test_random_resized_crop_matches_jax(shape, out, scale, seed):
    x = np.random.RandomState(seed).randint(0, 256, shape).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(JA.random_resized_crop(jnp.asarray(x), rng, out,
                                             scale=scale))
    got = TA.random_resized_crop_from_draws(
        torch.from_numpy(x), *_jax_draws(rng, shape[0], scale), out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_random_resized_crop_draws_from_the_generator():
    """Same generator state, same crops; crops stay inside 0..255."""
    x = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (3, 32, 40, 3)).astype(np.float32))
    a = TA.random_resized_crop(x, torch.Generator().manual_seed(1), 16)
    b = TA.random_resized_crop(x, torch.Generator().manual_seed(1), 16)
    c = TA.random_resized_crop(x, torch.Generator().manual_seed(2), 16)
    assert a.shape == (3, 16, 16, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 255


@pytest.mark.parametrize("out_h,out_w", [(16, 12), (64, 50), (20, 60)],
                         ids=["shrink", "grow", "mixed"])
def test_resize_bilinear_matches_jax(out_h, out_w):
    x = np.random.RandomState(5).randint(0, 256, (2, 37, 29, 3)).astype(
        np.float32)
    want = np.asarray(JA.resize_bilinear(jnp.asarray(x), out_h, out_w))
    got = TA.resize_bilinear(torch.from_numpy(x), out_h, out_w).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_center_crop_matches_jax():
    x = np.random.RandomState(6).randint(0, 256, (2, 37, 30, 3)).astype(
        np.uint8)
    want = np.asarray(JA.center_crop(jnp.asarray(x), 24))
    got = TA.center_crop(torch.from_numpy(x), 24).numpy()
    np.testing.assert_array_equal(got, want)
