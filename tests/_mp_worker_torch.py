"""Worker of tests/test_torch_mesh.py::test_two_process_gloo_mesh: one of
two port processes in one gloo group (a FileStore in the test's tmp_path),
each with the devices ['cpu', 'cpu'], runs the sharded engines and
randomized PCA over global_mesh(); rank 0 writes the results."""

import sys


def main():
    rank, work, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    import snprelate_tpu_torch as tsr
    from _torch_data import genotypes, ids
    from snprelate_tpu_torch.models.pca_randomized import randomized_pca
    from snprelate_tpu_torch.parallel.distributed import (global_mesh,
                                                          init_distributed)
    from snprelate_tpu_torch.parallel.mesh import (sharded_gcta_parts,
                                                   sharded_pair_counts)
    from snprelate_tpu_torch.workspace import init_workspace

    store = dist.FileStore(os.path.join(work, "store"), 2)
    init_distributed(num_processes=2, process_id=rank, device="cpu",
                     store=store, timeout_s=100)
    try:
        mesh = global_mesh(devices=["cpu", "cpu"])
        assert mesh.shape == {"data": 4, "samp": 1}
        g = genotypes(96, n_snp=700)  # as datasets(96), without JAX
        ws = init_workspace(tsr.create_geno(g, *ids(96, 700)),
                            missing_rate=0.01)[0]
        counts = sharded_pair_counts(ws, mesh, chunk=128)
        cov, vgram, nlocus = sharded_gcta_parts(ws, mesh, chunk=128)
        rp = randomized_pca(ws, eigen_cnt=4, aux_dim=8, iter_num=4, seed=3,
                            chunk=128, mesh=mesh)
        if rank == 0:
            np.savez(out, counts=np.stack(counts.base()), cov=cov,
                     vgram=vgram, nlocus=nlocus, eigenval=rp.eigenval[:4],
                     eigenvect=rp.eigenvect[:, :4])
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
