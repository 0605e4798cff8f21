"""ehyb_spmv — an explicit-caching hybrid (EHYB) SpMV framework in JAX.

JAX/XLA/Pallas implementation of the capabilities of
``Chong-Chen-UNLV/EHYB_SPMV_GPU`` (arXiv:2204.06666): Matrix Market I/O, an
x-window planner, a multilevel k-way graph partitioner (C++), two-level row
reordering, COO→EHYB conversion (DIA + SELL-128 body + ER tail + long-row
stream), a Pallas (Triton) SELL kernel for the GPU, golden-oracle validation,
benchmarking with roofline audits, and multi-device sharding over a mesh.

See SURVEY.md for the structural analysis of the reference this design is built
from (module docstrings carry file:line parity citations).
"""
from .config import EhybConfig, Features
from .core.coo import MatrixCOO, MatrixCSR, deterministic_x, oracle_spmv
from .core.planner import make_plan, Plan
from .core.reorder import two_level_reorder, Reordering
from .core.convert import coo_to_ehyb
from .core.ehyb import EhybMatrix, EhybDevice
from .models.csr import CsrSpmv, BcooSpmv
from .models.ehyb import EhybSpmv, EhybXlaSpmv, HybSpmv
from .utils.validate import compare, rel_error

__version__ = "0.1.0"

MODELS = {m.name: m for m in
          (CsrSpmv, BcooSpmv, EhybXlaSpmv, EhybSpmv, HybSpmv)}
