"""The port's key transforms, data generator and NumPy interop against the
JAX package's, bit for bit, for all 12 dtypes.

The JAX package is imported inside the tests that use it, so the ``gpu``
test also collects where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from mpi_k_selection_tpu_torch import config
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype, tensor_from_numpy, tensor_to_numpy

# one intra-op thread: in a parallel test run each worker's torch thread pool
# oversubscribes the cores, and small CPU ops stall on its barriers
torch.set_num_threads(1)

DTYPES = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs a CUDA device; on the card: "
            "python -m pytest --noconftest tests/test_torch_*.py -m gpu"
        )
    return torch.device("cuda")


def special_values(name, n=4000, seed=11):
    """Random bit patterns of ``name`` (NaNs, infinities, ±0.0 and
    subnormals included for floats) plus each boundary pattern."""
    nd = numpy_dtype(name)
    bits = nd.itemsize * 8
    udt = np.dtype(f"uint{bits}")
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, np.iinfo(udt).max, size=n, dtype=udt, endpoint=True)
    edges = np.array([0, 1, 1 << (bits - 1), (1 << (bits - 1)) - 1, (1 << bits) - 1], dtype=udt)
    return np.concatenate([raw, edges]).view(nd)


@pytest.mark.parametrize("name", DTYPES)
def test_keys_match_reference(name):
    import jax.numpy as jnp

    from mpi_k_selection_tpu.utils import dtypes as ref
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    x = special_values(name)
    want = ref.np_to_sortable_bits(x)
    np.testing.assert_array_equal(dt.np_to_sortable_bits(x), want)
    keys = dt.to_sortable_bits(tensor_from_numpy(x, "cpu"))
    assert keys.dtype == dt.key_dtype(x.dtype)
    bits = dt.key_bits(x.dtype)
    assert bits == ref.key_bits(x.dtype)
    assert dt.key_fold(x.dtype) == ref.key_fold(x.dtype)
    # carrier keys hold the unsigned key bits
    as_unsigned = keys.numpy().astype(np.int64).view(np.uint64) & np.uint64((1 << bits) - 1)
    np.testing.assert_array_equal(as_unsigned, want.astype(np.uint64))
    with enable_x64():
        jkeys = np.asarray(ref.to_sortable_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(jkeys, want)


@pytest.mark.parametrize("name", DTYPES)
def test_keys_round_trip_bit_for_bit(name):
    x = special_values(name)
    xt = tensor_from_numpy(x, "cpu")
    back = dt.from_sortable_bits(dt.to_sortable_bits(xt), xt.dtype)
    assert back.dtype == xt.dtype
    assert tensor_to_numpy(back).tobytes() == x.tobytes()
    u = dt.np_to_sortable_bits(x)
    assert dt.np_from_sortable_bits(u, x.dtype).tobytes() == x.tobytes()
    # key order is the documented total order: -0.0 below +0.0
    if name.startswith(("float", "bfloat")):
        z = np.array([0.0, -0.0]).astype(numpy_dtype(name))
        pos, neg = dt.order_bias(dt.to_sortable_bits(tensor_from_numpy(z, "cpu")), dt.key_bits(name)).tolist()
        assert neg < pos


@pytest.mark.parametrize("name", DTYPES)
def test_interop_round_trips_bit_for_bit(name):
    x = special_values(name)
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == dt.torch_dtype(name) and tuple(t.shape) == x.shape
    back = tensor_to_numpy(t)
    assert back.dtype == x.dtype and back.tobytes() == x.tobytes()
    x2 = x[:4000].reshape(4, -1)[:, ::3]  # non-contiguous input
    assert tensor_to_numpy(tensor_from_numpy(x2, "cpu")).tobytes() == np.ascontiguousarray(x2).tobytes()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize(
    "name", ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "float16", "float32", "float64"]
)
def test_datagen_is_byte_identical_to_reference(name, seed):
    from mpi_k_selection_tpu.utils import datagen as ref

    assert datagen.PATTERNS == ref.PATTERNS
    for pattern in datagen.PATTERNS:
        got = datagen.generate(3001, pattern=pattern, seed=seed, dtype=np.dtype(name), batch=(2,))
        want = ref.generate(3001, pattern=pattern, seed=seed, dtype=np.dtype(name), batch=(2,))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), pattern
    for (p1, a), (p2, b) in zip(
        datagen.adversarial_fixtures(3001, dtype=np.dtype(name), seed=seed),
        ref.adversarial_fixtures(3001, dtype=np.dtype(name), seed=seed),
        strict=True,
    ):
        assert p1 == p2 and a.tobytes() == b.tobytes(), p1


def test_config_matches_reference():
    from mpi_k_selection_tpu import config as ref

    for name in ("REFERENCE_K_SEQ", "REFERENCE_K_CGM", "DEFAULT_SEED"):
        assert getattr(config, name) == getattr(ref, name), name


def test_unsupported_dtype_raises():
    with pytest.raises(TypeError, match="unsupported"):
        dt.key_bits(torch.complex64)
    with pytest.raises(TypeError, match="unsupported"):
        dt.torch_dtype("bool")


@pytest.mark.gpu
@pytest.mark.parametrize("name", DTYPES)
def test_keys_on_card_match_cpu(cuda_device, name):
    x = special_values(name, n=1 << 20)
    on_card = dt.to_sortable_bits(tensor_from_numpy(x, cuda_device))
    on_cpu = dt.to_sortable_bits(tensor_from_numpy(x, "cpu"))
    assert torch.equal(on_card.cpu(), on_cpu)
    back = dt.from_sortable_bits(on_card, dt.torch_dtype(name))
    assert tensor_to_numpy(back).tobytes() == x.tobytes()
