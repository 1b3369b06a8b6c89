"""snprelate_tpu_torch — the PyTorch / CUDA port of snprelate_tpu for an
NVIDIA H100: relatedness and PCA from packed 2-bit genotypes on
hand-written CUDA kernels: IBS, KING (robust and homo), dissimilarity,
PLINK method-of-moments IBD, individual beta, GRM (GCTA, Eigenstrat, Corr,
EIGMIX, IndivBeta), EIGMIX, exact and randomized PCA, and the streaming
KING-robust relatedness screen (``king_ibd_selection``), and the PCA
workflow past the slab budget: slab-wise and rank-partitioned randomized
PCA (``models/pca_randomized.randomized_pca_slabs``,
``models/pca_rank``), SNP-PC correlations, SNP loadings and sample
projection (``pca_corr``, ``pca_snp_loading``, ``pca_samp_loading``),
and the serving path: ``king_cross`` and ``serve.CohortService`` (new
samples related to and projected onto a cohort resident on the card),
with the host statistics it needs (``select_snp``, ``snp_rate_freq``,
``samp_miss_rate``, ``get_geno``, ``summary``, ``hwe``, ``ind_inb``,
``ind_inb_coef``, ``create_geno_set``), and LD pruning, LD matrices and
Fst: ``ld_pruning`` and ``ld_mat`` on the joint-count and LD-measure
kernels (dense tiles below 4,096 samples, device-resident packed rows
past it), ``fst`` on the population-count kernel, and the host
``ld_pair`` and ``apart_selection``, and maximum-likelihood IBD and
clustering: ``ibd_mle`` (EM, downhill simplex, Jacquard) and
``ibd_mle_loglik`` on the per-pair EM, simplex and log-likelihood
kernels, the host ``pair_ibd``, ``pair_ibd_mle_loglik`` and
``ibd_selection``, ``hcluster``, ``cut_tree`` (its permutation sums of
large merges on the permutation cross-sum kernel), ``draw_tree``,
``admix_prop``, ``admix_plot`` and ``admix_table``.
The count and GRM analyses take ``sample_block=`` for the row-strip route,
which keeps device memory O(block x N), and past the slab-staging budget
(or with ``tiles=True`` / ``tile_rank=``) the super-tile route of
``ops/tiles.py``, which also bounds host -> device traffic and splits the
tiles over independent processes.

Public functions mirror the JAX package's names and ``snpgds*`` aliases
and take ``device=``: ``None`` means the CUDA card and raises when there is
none; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from .io.store import (SNPData, create_geno, open_packed_store,
                       save_packed_store)
from .workspace import Workspace, init_workspace, snp_stats
from .utils.packed import PackedSymmetric
from .models.ibs import ibs, ibs_num
from .models.king import ibd_king, king_ibd_selection
from .models.grm import grm
from .models.pca import pca
from .models.pca_ext import pca_corr, pca_snp_loading, pca_samp_loading
from .models.eigmix import eigmix
from .models.diss import diss
from .models.ibd_mom import ibd_mom
from .models.beta import indiv_beta, indiv_beta_rel
from .models.king import king_cross
from .models.hwe import hwe
from .models.inbreeding import ind_inb, ind_inb_coef
from .models.stats import (get_geno, samp_miss_rate, select_snp,
                           snp_rate_freq, summary)
from .models.misc import create_geno_set
from .models.ld import apart_selection, ld_mat, ld_pair, ld_pruning
from .models.fst import fst
from .models.ibd_mle import (ibd_mle, ibd_mle_loglik, ibd_selection, pair_ibd,
                             pair_ibd_mle_loglik)
from .models.cluster import (admix_plot, admix_prop, admix_table, cut_tree,
                             draw_tree, hcluster)

# Reference-style aliases
snpgdsCreateGeno = create_geno
snpgdsIBS = ibs
snpgdsIBSNum = ibs_num
snpgdsIBDKING = ibd_king
snpgdsGRM = grm
snpgdsPCA = pca
snpgdsPCACorr = pca_corr
snpgdsPCASNPLoading = pca_snp_loading
snpgdsPCASampLoading = pca_samp_loading
snpgdsEIGMIX = eigmix
snpgdsDiss = diss
snpgdsIBDMoM = ibd_mom
snpgdsIndivBeta = indiv_beta
snpgdsIndivBetaRel = indiv_beta_rel
snpgdsHWE = hwe
snpgdsIndInb = ind_inb
snpgdsIndInbCoef = ind_inb_coef
snpgdsSNPRateFreq = snp_rate_freq
snpgdsSampMissRate = samp_miss_rate
snpgdsSelectSNP = select_snp
snpgdsGetGeno = get_geno
snpgdsSummary = summary
snpgdsCreateGenoSet = create_geno_set
snpgdsLDpair = ld_pair
snpgdsLDMat = ld_mat
snpgdsLDpruning = ld_pruning
snpgdsApartSelection = apart_selection
snpgdsFst = fst
snpgdsIBDMLE = ibd_mle
snpgdsIBDMLELogLik = ibd_mle_loglik
snpgdsPairIBD = pair_ibd
snpgdsPairIBDMLELogLik = pair_ibd_mle_loglik
snpgdsIBDSelection = ibd_selection
snpgdsHCluster = hcluster
snpgdsCutTree = cut_tree
snpgdsDrawTree = draw_tree
snpgdsAdmixProp = admix_prop
snpgdsAdmixPlot = admix_plot
snpgdsAdmixTable = admix_table

__version__ = "0.1.0"
