"""Long-lived service over a cohort resident on the card.

``CohortService`` loads a cohort once, fits PCA and the SNP loadings, and
stages the packed cohort on the device; each request is then a
rectangular product against the staged cohort, never an O(n^2)
recomputation (snpgdsPCASampLoading projection, R/PCA.R:243; KING
relatedness, R/IBD.R:333). ``make_server`` puts it behind HTTP:

  GET  /health    {"status": "ok", "n_samp": n, "n_snp": s, "eigen_cnt": k}
  GET  /snps      the served SNP order: {"snp_id": [...]}; queries send
                  genotype vectors in this order (0/1/2, 3 = missing)
  GET  /freq      {"snp_id": [...], "allele_freq": [...]}
  POST /project   {"genotypes": [[...], ...]} -> {"coords": [[PC1..PCk]]}
  POST /kinship   {"genotypes": [[...]], "cutoff": 0.0442}
                  -> {"matches": [[{"sample_id", "kinship", "ibs0"}, ...]]}
  POST /ibs       {"genotypes": [[...]], "top": 10}
                  -> {"matches": [[{"sample_id", "ibs", "ibs0", "ibs2",
                     "nvalid"}, ...]]}, the top cohort samples by average
                     IBS (snpgdsIBS semantics, genIBS.cpp:470-475)

/kinship and /ibs run one pass of ``gram5_cross`` (K8) per staged chunk,
/project one of ``rand_yt`` (K3b). Every launch runs under the service's
lock, on the current stream of its device, and the kernels are built when
the service is made, not inside a request.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .utils.device import resolve_device


class CohortService:
    """The state behind the endpoints; usable directly in process.
    ``timings`` holds the host wall seconds of each start-up step.
    device: None = the CUDA card; "cpu" runs the plain versions."""

    def __init__(self, data, eigen_cnt: int = 16, sample_id=None,
                 snp_id=None, autosome_only=True, remove_monosnp=True,
                 maf=math.nan, missing_rate=0.01, algorithm="exact",
                 verbose=False, device=None):
        from .models.misc import create_geno_set
        from .models.pca import pca
        from .models.pca_ext import pca_snp_loading
        from .models.stats import select_snp, snp_rate_freq
        from .ops import kernels
        from .ops.pairwise import _stage_or_stream, auto_chunk
        from .workspace import init_workspace

        self.device = dev = resolve_device(device)
        self.timings = {}

        def step(name, fn, *a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings[name] = time.perf_counter() - t
            return r

        if dev.type == "cuda":
            step("build", kernels.prepare, "gram5_cross", "rand_yt")
        # resolve the filter once, so every endpoint shares one SNP order
        keep = step("select_snp", select_snp, data, sample_id=sample_id,
                    snp_id=snp_id, autosome_only=autosome_only,
                    remove_monosnp=remove_monosnp, maf=maf,
                    missing_rate=missing_rate, verbose=verbose)
        self.cohort = step("create_geno_set", create_geno_set, data,
                           sample_id=sample_id, snp_id=keep)
        self.snp_id = np.asarray(self.cohort.snp_id)
        self.pca = step("pca", pca, self.cohort, eigen_cnt=eigen_cnt,
                        algorithm=algorithm, autosome_only=False,
                        remove_monosnp=False, missing_rate=math.nan,
                        verbose=verbose, device=dev)
        self.loadings = step("pca_snp_loading", pca_snp_loading, self.pca,
                             self.cohort, verbose=verbose, device=dev)
        self.freq = step("snp_rate_freq", snp_rate_freq,
                         self.cohort)["AlleleFreq"]
        self.eigen_cnt = eigen_cnt
        self._lock = threading.Lock()
        # stage the packed cohort chunks once (on the device when they fit
        # the slab-staging budget), so a request sends only its query
        self._ws = step("init_workspace", init_workspace, self.cohort,
                        autosome_only=False, remove_monosnp=False,
                        missing_rate=math.nan)[0]
        n_pad = -(-self._ws.n_samp // 128) * 128
        self._chunk = auto_chunk(self._ws.n_snp, dev)
        self._staged = step("stage", _stage_or_stream, self._ws, self._chunk,
                            n_pad, dev)

    def _check_query(self, genotypes) -> np.ndarray:
        g = np.asarray(genotypes)
        if g.ndim == 1:
            g = g[None, :]
        if g.ndim != 2 or g.shape[1] != len(self.snp_id):
            raise ValueError(
                f"genotypes must be (q, {len(self.snp_id)}) in the /snps "
                f"order; got {g.shape}")
        g = np.where(np.isfinite(g.astype(np.float64)), g, 3.0)
        if not np.array_equal(g, np.round(g)):
            raise ValueError(
                "genotypes have fractional dosages; hard-call to 0/1/2 "
                "(3 or NaN = missing) first")
        g = g.astype(np.int64)
        if ((g < 0) | (g > 3)).any():
            raise ValueError("genotype values must be 0/1/2 or 3=missing")
        return g.astype(np.uint8)

    def _counts(self, g):
        from .ops.pairwise import cross_pair_counts

        return cross_pair_counts(self._ws, g, chunk=self._chunk,
                                 staged=self._staged, device=self.device)

    def project(self, genotypes) -> np.ndarray:
        """PC coordinates of new samples (snpgdsPCASampLoading)."""
        from .io.store import create_geno
        from .models.pca_ext import pca_samp_loading

        g = self._check_query(genotypes)
        tiny = create_geno(
            g.T, sample_id=[f"query{i}" for i in range(g.shape[0])],
            snp_id=self.snp_id,
            snp_position=self.cohort.snp_position,
            snp_chromosome=self.cohort.snp_chromosome,
            snp_allele=self.cohort.snp_allele, snpfirstdim=True)
        with self._lock:
            r = pca_samp_loading(self.loadings, tiny, device=self.device)
        return r.eigenvect

    def kinship(self, genotypes, cutoff=0.0442):
        """KING-robust matches of each query sample above ``cutoff``."""
        from .models.king import king_cross_from_counts

        g = self._check_query(genotypes)
        with self._lock:
            c = self._counts(g)
        r = king_cross_from_counts(c, self._ws.sample_id, self._ws.snp_id)
        out = []
        for qi in range(g.shape[0]):
            kin = r.kinship[qi]
            hits = np.where(np.nan_to_num(kin, nan=-np.inf) >= cutoff)[0]
            order = hits[np.argsort(kin[hits])[::-1]]
            out.append([{"sample_id": str(r.sample_id[j]),
                         "kinship": float(kin[j]),
                         "ibs0": float(r.IBS0[qi, j])} for j in order])
        return out

    def ibs(self, genotypes, top=10):
        """Top ``top`` cohort samples per query by average IBS
        (0.5 IBS1 + IBS2) / nvalid, over the same staged cross counts as
        /kinship."""
        g = self._check_query(genotypes)
        with self._lock:
            c = self._counts(g)
        total = c.nvalid.astype(np.float64)
        with np.errstate(invalid="ignore"):
            avg = (0.5 * c.ibs1 + c.ibs2) / total
        top = min(int(top), avg.shape[1])
        # each counter (and the workspace's ids) once, not per match: a
        # property recomputes the whole (q, n) array on every access
        sid, ibs0, ibs2 = self._ws.sample_id, c.ibs0, c.ibs2
        out = []
        for qi in range(g.shape[0]):
            row = np.nan_to_num(avg[qi], nan=-np.inf)
            order = np.argsort(row)[::-1][:top]
            out.append([{"sample_id": str(sid[j]),
                         "ibs": float(avg[qi, j]),
                         "ibs0": int(ibs0[qi, j]),
                         "ibs2": int(ibs2[qi, j]),
                         "nvalid": int(c.nvalid[qi, j])} for j in order])
        return out

    def health(self):
        return {"status": "ok", "n_samp": int(self.cohort.n_samp),
                "n_snp": int(self.cohort.n_snp),
                "eigen_cnt": int(self.eigen_cnt)}


def _make_handler(svc: CohortService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/health":
                    self._send(svc.health())
                elif self.path == "/snps":
                    self._send({"snp_id": [str(s) for s in svc.snp_id]})
                elif self.path == "/freq":
                    self._send({"snp_id": [str(s) for s in svc.snp_id],
                                "allele_freq":
                                    np.asarray(svc.freq, float).tolist()})
                else:
                    self._send({"error": f"unknown path {self.path}"}, 404)
            except Exception as e:  # noqa: BLE001 - report, keep serving
                self._send({"error": str(e)}, 500)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/project":
                    coords = svc.project(req["genotypes"])
                    self._send({"coords": coords.tolist()})
                elif self.path == "/kinship":
                    out = svc.kinship(req["genotypes"],
                                      cutoff=float(req.get("cutoff",
                                                           0.0442)))
                    self._send({"matches": out})
                elif self.path == "/ibs":
                    out = svc.ibs(req["genotypes"],
                                  top=int(req.get("top", 10)))
                    self._send({"matches": out})
                else:
                    self._send({"error": f"unknown path {self.path}"}, 404)
            except (KeyError, ValueError, TypeError) as e:
                self._send({"error": str(e)}, 400)
            except Exception as e:  # noqa: BLE001
                self._send({"error": str(e)}, 500)

    return Handler


def make_server(svc: CohortService, host="127.0.0.1", port=0):
    return ThreadingHTTPServer((host, port), _make_handler(svc))


def serve(gds, host="127.0.0.1", port=8799, eigen_cnt=16, verbose=True,
          device=None, **filters):
    """Serve an already-open SNPData. A GDS path needs the GDS reader,
    which is not ported yet, and raises."""
    if isinstance(gds, str):
        raise NotImplementedError(
            "serve: a GDS path needs the GDS reader (io/gds.py, "
            "open_snp_gds), which is not ported yet (ROADMAP section 1 "
            "item 7c); pass an SNPData")
    data = gds
    if verbose:
        print(f"loading cohort ({data.n_samp} samples x {data.n_snp} SNPs) "
              f"and fitting {eigen_cnt}-PC loadings ...")
    svc = CohortService(data, eigen_cnt=eigen_cnt, verbose=verbose,
                        device=device, **filters)
    httpd = make_server(svc, host, port)
    if verbose:
        print(f"serving on http://{host}:{httpd.server_address[1]} "
              f"({svc.cohort.n_samp} samples x {svc.cohort.n_snp} SNPs)")
    httpd.serve_forever()
