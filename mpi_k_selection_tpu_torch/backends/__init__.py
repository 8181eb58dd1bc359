"""Backend registry: ``seq`` (the CPU oracle), ``cuda`` (PyTorch on a
CUDA card, or its plain versions on the CPU), ``mpi`` (the native
multi-process CGM): the ``--backend={seq,cuda,mpi}`` surface of the CLI,
the JAX package's ``{seq,tpu,mpi}`` with the card in place of the TPU."""

BACKENDS = ("seq", "cuda", "mpi")


def get_backend(name: str):
    if name == "seq":
        from mpi_k_selection_tpu_torch.backends import seq

        return seq
    if name == "cuda":
        from mpi_k_selection_tpu_torch.backends import cuda

        return cuda
    if name == "mpi":
        from mpi_k_selection_tpu_torch.backends import mpi

        return mpi
    raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")
