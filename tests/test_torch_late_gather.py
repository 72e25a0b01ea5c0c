"""The port's plain ``late_gather`` against the JAX Pallas kernel (interpret
mode, as tests/test_kernels.py runs it) and the JAX oracle.

Inputs are made with numpy from a seed and handed to both packages.  A
gather does no arithmetic, so equality is exact, bit for bit (the
tolerance is 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.late_gather import late_gather_pallas, late_gather_ref
from repro_torch.kernels.late_gather import late_gather as port_late_gather
from repro_torch.kernels.late_gather.ref import \
    late_gather_ref as port_late_gather_ref

DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16),
          "int32": (jnp.int32, torch.int32, np.uint32)}


def to_torch(a) -> "torch.Tensor":
    """A JAX array as a torch tensor of the same dtype and bits (numpy has
    no bfloat16 of its own, so 2-byte floats cross as raw bits)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a, unsigned) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        signed = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.view(signed).numpy().view(unsigned)
    return np.asarray(a).view(unsigned)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,w,p", [(8, 1, 4), (64, 37, 25), (128, 128, 200),
                                   (33, 260, 7)])
def test_late_gather_matches_pallas_and_ref(dtype, r, w, p):
    jdt, tdt, unsigned = DTYPES[dtype]
    rng = np.random.default_rng(1000 * r + p)
    tab = jnp.asarray(rng.standard_normal((r, w)) * 10).astype(jdt)
    pos_np = rng.integers(0, r + 5, p).astype(np.int32)   # some sentinels
    want_pallas = late_gather_pallas(tab, jnp.asarray(pos_np))
    want_ref = late_gather_ref(tab, jnp.asarray(pos_np))

    got = port_late_gather(to_torch(tab), torch.from_numpy(pos_np))
    assert got.dtype == tdt and tuple(got.shape) == (p, w)
    np.testing.assert_array_equal(bits(got, unsigned),
                                  bits(want_pallas, unsigned))
    np.testing.assert_array_equal(bits(got, unsigned),
                                  bits(want_ref, unsigned))


def test_late_gather_int32_keeps_bits_above_2_pow_24():
    """The port gathers int32 columns in their own dtype: ids above 2^24,
    which an f32 round trip would round, come back exact."""
    tab = torch.tensor([[2 ** 24 + 1], [2 ** 31 - 1], [-(2 ** 24) - 3]],
                       dtype=torch.int32)
    pos = torch.tensor([2, 0, 1, 3, 9], dtype=torch.int32)
    got = port_late_gather(tab, pos)
    assert got[:, 0].tolist() == [-(2 ** 24) - 3, 2 ** 24 + 1, 2 ** 31 - 1,
                                  0, 0]


def test_late_gather_wrapper_takes_plain_version_on_cpu():
    from repro_torch.kernels.late_gather import ops
    before = ops.LAUNCHES
    tab = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    pos = torch.tensor([3, 4, 0], dtype=torch.int32)
    assert torch.equal(port_late_gather(tab, pos),
                       port_late_gather_ref(tab, pos))
    assert ops.LAUNCHES == before          # no kernel ran on the CPU


def test_late_gather_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.late_gather import late_gather_cuda
    tab = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        late_gather_cuda(tab, torch.zeros((2,), dtype=torch.int32))
