"""Build and load the port's CUDA kernels (sources in ``../csrc``).

Nothing here runs at import: a kernel library is compiled by ``nvcc`` the
first time :func:`load` asks for it (:func:`build_libraries` builds several
at once), into ``lintransunet_tpu_torch/_build`` (listed in
``.gitignore``), keyed on a hash of its source, the shared headers and the
flags.
"""

from lintransunet_tpu_torch.kernels.build import (
    SIGNATURES,
    build_libraries,
    build_log,
    load,
)

__all__ = ["SIGNATURES", "build_libraries", "build_log", "load"]
