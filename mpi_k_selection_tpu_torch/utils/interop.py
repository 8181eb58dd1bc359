"""Moving selection inputs between NumPy and PyTorch, bit for bit.

k-selection carries no weights: what crosses between the JAX package and
this port is the data array itself. These two functions move every dtype
the JAX package accepts without changing a bit — the unsigned dtypes and
``bfloat16`` (``ml_dtypes`` on the NumPy side) travel through a signed
integer view of the same width, so no value conversion ever runs.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.utils import dtypes as _dt

_SIGNED_NP = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def numpy_dtype(name) -> np.dtype:
    """NumPy dtype for a dtype name; ``"bfloat16"`` resolves through
    ``ml_dtypes`` (imported only then)."""
    if str(name) == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """``arr`` as a torch tensor on ``device``, the same bits and shape."""
    arr = np.ascontiguousarray(np.asarray(arr))
    dt = _dt.torch_dtype(arr.dtype)
    bits = torch.from_numpy(arr.view(_SIGNED_NP[arr.dtype.itemsize]))
    return bits.to(device).view(dt)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host NumPy array of the matching dtype, the same bits."""
    t = t.detach().contiguous().cpu()
    np_dt = numpy_dtype(str(t.dtype).removeprefix("torch."))
    return t.view(_dt._SIGNED[_dt.key_bits(t.dtype)]).numpy().view(np_dt)
