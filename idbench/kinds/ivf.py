"""The IVF kind: the port's ``IndexIVF`` searched with deferred id decoding.

The five names of ``kinds/__init__.py``:

- ``make_inputs``: ``data.make_inputs``, the clustered corpus whose centres
  are the index's centroids (and PQ codebooks drawn from its rows);
- ``build``: centroids (and codebooks) set, ``add``, the id container of
  ``id_codec`` swapped in; the scan path checked against ``scan_path``;
- ``call``: ``IndexIVF.search_defer_id_decoding`` at the traffic's k and the
  configuration's nprobe;
- ``Spans``: CUDA events around ``search_positional`` and ``_translate``, the
  lanes of each ROC decode; ``context`` adds ``spans``, ``decodes``,
  ``container`` and ``ntotal`` to the readers' ``ctx``;
- ``Reference``: the float64 reference ``reference/ivf.py`` judges the
  sampled calls' results by two numbers, each the largest over the sampled
  queries, each beside its limit from the configuration file (``limits``):

  - ``dist_err``: a returned distance against the reference's distance of
    the returned id, relative to 2 ||x||^2 (the scan, the translate);
  - ``rank_gap``: the returned results against the reference's top-k over
    the lists the query surely probes (the coarse stage, the scan's
    completeness, the merge; a missing, repeated or unprobed id reads
    ``reference.ivf.MISSING``).

  Its ``control``: the reference in TF32 (operands of every dot product
  rounded to TF32) in the program's place.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import torch

from idbench import check as verdicts
from idbench.data import make_inputs
from idbench.kinds import SetupError
from idbench.reference.ivf import ReferenceIVF


def build(cfg: dict, inputs, device: torch.device):
    """The port's index over the inputs, through its own API: centroids (and
    PQ codebooks) set, ``add``, the id container of ``id_codec`` swapped in.
    Raises ``SetupError`` where the scan path differs from ``scan_path``."""
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
    from vector_db_id_compression_tpu_torch.store.invlists import AVAILABLE_COMPRESSED_IVFS

    index = IndexIVF(cfg["d"], cfg["nlist"], storage=cfg["payload"], pq_m=cfg.get("pq_m", 0),
                     nprobe=cfg["nprobe"], quantizer=cfg["quantizer"], device=device)
    index.centroids = inputs.centroids
    if inputs.codebooks is not None:
        index.pq.centroids = inputs.codebooks
    index.add(inputs.xb)
    index.replace_invlists(AVAILABLE_COMPRESSED_IVFS[cfg["id_codec"]](index.invlists,
                                                                      device=device))
    path = "float" if index._scan_is_float else "lut"
    if path != cfg["scan_path"]:
        raise SetupError(f"the port took the {path} scan, the configuration states "
                         f"{cfg['scan_path']}")
    return index


def call(index, cfg: dict, traffic: dict, xq: torch.Tensor):
    """(D, I) of ``search_defer_id_decoding`` over ``xq``."""
    return index.search_defer_id_decoding(xq, traffic["k"], cfg["nprobe"],
                                          decode_1by1=cfg["translate"] == "random_access")


class Spans:
    """The traced run's spans around the port's layers: CUDA events (host
    clock on the CPU) around ``search_positional`` and ``_translate``, and
    the lanes of each ROC decode while the profiler records."""

    def __init__(self, index, device: torch.device):
        self.index = index
        self.device = device
        self.events: Dict[str, list] = {"positional": [], "translate": []}
        self.decodes: list = []
        self.recording = False
        for attr, name in (("search_positional", "positional"), ("_translate", "translate")):
            setattr(index, attr, self._wrap(getattr(index, attr), name))
        decoder = getattr(index.active, "decoder", None)
        if decoder is not None:
            decode_lanes = decoder.decode_lanes

            def recorded(idx, _f=decode_lanes, _d=decoder):
                if self.recording:
                    self.decodes.append((_d, idx))
                return _f(idx)
            decoder.decode_lanes = recorded

    def _wrap(self, fn, name):
        cuda = self.device.type == "cuda"

        def timed(*a, **kw):
            if cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events[name].append((e0, e1))
            else:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.events[name].append(time.perf_counter() - t0)
            return out
        return timed

    def ms(self, name: str) -> List[float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) for a, b in self.events[name]]
        return [1e3 * t for t in self.events[name]]

    def context(self) -> dict:
        """The readers' IVF fields: ``spans`` (ms a call, by span), ``decodes``
        ((decoder, lanes) of each profiled decode), ``container`` (the active
        id container) and ``ntotal``."""
        return {"spans": {n: self.ms(n) for n in self.events}, "decodes": self.decodes,
                "container": self.index.active, "ntotal": self.index.ntotal}


class Reference:
    """The inputs made again from the seed and the float64 reference over
    them, built once; ``judge`` reads the sampled calls' results, ``control``
    the TF32 reference's answers to the same queries in their place."""

    def __init__(self, cfg: dict, seed: int, pool: int, device: torch.device):
        self.cfg, self.device = cfg, device
        t0 = time.perf_counter()
        self.inputs = make_inputs(cfg, seed, pool, device)
        t1 = time.perf_counter()
        self.ref = ReferenceIVF(self.inputs.centroids, self.inputs.xb, self.inputs.codebooks)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # the reference's own build, the inputs apart
        self.seconds = {"inputs": t1 - t0, "reference": time.perf_counter() - t1}

    def judge(self, traffic: dict, sample) -> dict:
        D = torch.cat([out[0] for _, out in sample])
        I = torch.cat([out[1] for _, out in sample])
        return self._verdict(self._queries(traffic, sample), D, I)

    def control(self, traffic: dict, sample) -> dict:
        i = self.inputs
        xq = self._queries(traffic, sample)
        D, I = ReferenceIVF(i.centroids, i.xb, i.codebooks, precision="tf32").search(
            xq, traffic["k"], self.cfg["nprobe"])
        return self._verdict(xq, D, I)

    def _queries(self, traffic: dict, sample) -> torch.Tensor:
        nq = traffic["queries_per_call"]
        return torch.cat([self.inputs.queries[s:s + nq] for s, _ in sample])

    def _verdict(self, xq, D, I) -> dict:
        t0 = time.perf_counter()
        dist_err, rank_gap = self.ref.judge(xq, D, I, self.cfg["nprobe"])
        out = verdicts.judge({"dist_err": dist_err, "rank_gap": rank_gap}, self.cfg["limits"])
        parts = ", ".join(f"{k} {v:.3f} s" for k, v in {**self.seconds, **self.ref.seconds}.items())
        print(f"reference: {parts}; judging {xq.shape[0]} queries "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return out
