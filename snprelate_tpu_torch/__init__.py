"""snprelate_tpu_torch — the PyTorch / CUDA port of snprelate_tpu for an
NVIDIA H100: relatedness and PCA from packed 2-bit genotypes, with the
main path (IBS, KING-robust, GRM, exact PCA) on hand-written CUDA kernels.

Public functions mirror the JAX package's names and ``snpgds*`` aliases
and take ``device=``: ``None`` means the CUDA card and raises when there is
none; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from .io.store import (SNPData, create_geno, open_packed_store,
                       save_packed_store)
from .workspace import Workspace, init_workspace, snp_stats
from .utils.packed import PackedSymmetric
from .models.ibs import ibs, ibs_num
from .models.king import ibd_king
from .models.grm import grm
from .models.pca import pca

# Reference-style aliases
snpgdsCreateGeno = create_geno
snpgdsIBS = ibs
snpgdsIBSNum = ibs_num
snpgdsIBDKING = ibd_king
snpgdsGRM = grm
snpgdsPCA = pca

__version__ = "0.1.0"
