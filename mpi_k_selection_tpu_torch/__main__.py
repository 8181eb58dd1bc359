import sys

from mpi_k_selection_tpu_torch.cli import main

sys.exit(main())
