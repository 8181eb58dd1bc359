"""ctypes bindings for the native runtime (kselect_native.cpp).

A thin typed wrapper object, the library built at first use. A failed
build or load makes :func:`get_lib` return None: the ``seq`` backend then
answers with NumPy, and the ``mpi`` backend raises
:class:`~mpi_k_selection_tpu_torch.errors.NativeUnavailableError`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None  # ksel: guarded-by[_lock]
_failed = False  # ksel: guarded-by[_lock]

_NTH = {
    np.dtype(np.int32): ("nth_element_i32", ctypes.c_int32),
    np.dtype(np.int64): ("nth_element_i64", ctypes.c_int64),
    np.dtype(np.float32): ("nth_element_f32", ctypes.c_float),
    np.dtype(np.float64): ("nth_element_f64", ctypes.c_double),
}


class NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll
        for name, ctyp in _NTH.values():
            fn = getattr(cdll, name)
            fn.argtypes = [ctypes.POINTER(ctyp), ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctyp)]
            fn.restype = ctypes.c_int
        cg = cdll.cgm_kselect_i32
        cg.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        cg.restype = ctypes.c_int

    def nth_element(self, x: np.ndarray, k: int):
        """k-th smallest (1-indexed) via std::nth_element; None if the
        dtype has no entry point."""
        x = np.ascontiguousarray(x).ravel()
        entry = _NTH.get(x.dtype)
        if entry is None:
            return None
        name, ctyp = entry
        out = ctyp(0)
        rc = getattr(self._cdll, name)(x.ctypes.data_as(ctypes.POINTER(ctyp)), x.size, int(k), ctypes.byref(out))
        if rc != 0:
            raise ValueError(f"native nth_element failed (rc={rc}, k={k}, n={x.size})")
        return x.dtype.type(out.value)

    def cgm_kselect(self, x: np.ndarray, k: int, *, num_procs: int, c: int):
        """Distributed CGM selection over forked ranks, int32 only (the
        reference operates on C int). Returns (answer, rounds, elapsed_s,
        found_early)."""
        x = np.ascontiguousarray(x, dtype=np.int32).ravel()
        ans = ctypes.c_int32(0)
        rounds = ctypes.c_int64(0)
        elapsed = ctypes.c_double(0.0)
        found = ctypes.c_int32(0)
        rc = self._cdll.cgm_kselect_i32(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            x.size,
            int(k),
            int(num_procs),
            int(c),
            ctypes.byref(ans),
            ctypes.byref(rounds),
            ctypes.byref(elapsed),
            ctypes.byref(found),
        )
        if rc == 1:
            raise ValueError(
                f"invalid CGM arguments (n={x.size}, k={k}, num_procs={num_procs}, "
                f"c={c}); num_procs must be in [2, 64] — the reference aborts the "
                "same way (TODO-kth-problem-cgm.c:56-59)"
            )
        if rc != 0:
            raise RuntimeError(f"native CGM runtime failed (rc={rc})")
        return int(ans.value), int(rounds.value), float(elapsed.value), bool(found.value)


def get_lib() -> NativeLib | None:
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            return None
        try:
            from mpi_k_selection_tpu_torch.native.build import build

            _lib = NativeLib(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, AttributeError):
            _failed = True
            return None
        return _lib
