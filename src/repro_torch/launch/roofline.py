"""Roofline terms of dry-run records, and the model FLOPs of a step; the
counterpart of ``src/repro/launch/roofline.py``, on the H100 constants of
``launch/mesh.py``.

Terms (seconds per step), per card:
  compute    = flops_global / (chips x PEAK_FLOPS)
  memory     = bytes_global / (chips x HBM_BW)
  collective = collective bytes a device sends / NVLINK_BW

FLOPs and bytes come from the dry run's global cost count, collective
bytes from its per-device counter (``launch/dryrun.py``).  The collective
term is a lower bound for an axis that leaves an 8-card node: NVLink joins
the cards of a node, and traffic between nodes crosses a slower network.
``model_flops`` is 6·N·D for training (N = active params for MoE, D =
tokens), 2·N·D for prefill, 2·N a decode request; the ratio of model to
counted FLOPs shows how much of the counted compute is "useful" (remat and
routing push it down).  ``fits`` compares the predicted per-device bytes
with the card's 80 GB.

  python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Union

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS


def model_flops(arch: Union[str, ModelConfig],
                shape: Union[str, InputShape]) -> float:
    """``arch`` an id or a config (e.g. one cut in depth), ``shape`` a
    name of ``SHAPES_BY_NAME`` or an ``InputShape``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token per request


def peak_share(flops: float, seconds: float) -> float:
    """FLOPs done in ``seconds`` as a share of the card's bf16 peak."""
    return flops / (seconds * PEAK_FLOPS)


def terms(rec: Dict) -> Dict:
    chips = rec["n_chips"]
    comp = rec["flops_global"] / (chips * PEAK_FLOPS)
    memt = rec["bytes_global"] / (chips * HBM_BW)
    coll = sum(rec["collective_bytes_per_device"].values()) / NVLINK_BW
    dom = max(("compute", comp), ("memory", memt), ("collective", coll),
              key=lambda kv: kv[1])[0]
    # the config and shape the record was made at (a cut or reduced one)
    cfg = get_config(rec["arch"])
    cfg = cfg.reduced() if rec.get("reduced") else cfg
    cfg = dataclasses.replace(cfg, n_layers=rec.get("n_layers",
                                                    cfg.n_layers))
    shape = SHAPES_BY_NAME[rec["shape"]]
    shape = dataclasses.replace(
        shape, global_batch=rec.get("global_batch", shape.global_batch),
        seq_len=rec.get("seq_len", shape.seq_len))
    mf = model_flops(cfg, shape)
    mem = rec["memory"]
    hbm = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    return {
        "compute_s": comp, "memory_s": memt, "collective_s": coll,
        "dominant": dom, "model_flops": mf,
        "useful_ratio": mf / max(rec["flops_global"], 1.0),
        "hbm_gib_per_dev": hbm / 2 ** 30,
        "fits": hbm <= HBM_BYTES,
    }


REQUIRED = ("n_chips", "flops_global", "bytes_global",
            "collective_bytes_per_device", "memory", "arch", "shape")


def load_records(dir_: str = "experiments/dryrun_torch") -> List[Dict]:
    recs = []
    for p in sorted(Path(dir_).glob("*.json")):
        r = json.loads(p.read_text())
        if not all(k in r for k in REQUIRED):
            continue                  # side artifacts
        r["file"] = p.name
        recs.append(r)
    return recs


def table(recs: List[Dict], fmt: str = "md") -> str:
    rows = []
    head = ("arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
            "dominant", "useful", "HBM GiB/dev")
    for r in recs:
        t = terms(r)
        rows.append((r["arch"], r["shape"], r["mesh"],
                     f"{t['compute_s']:.3f}", f"{t['memory_s']:.3f}",
                     f"{t['collective_s']:.3f}", t["dominant"],
                     f"{t['useful_ratio']:.2f}",
                     f"{t['hbm_gib_per_dev']:.1f}"
                     + ("" if t["fits"] else " ⚠")))
    if fmt == "md":
        out = ["| " + " | ".join(head) + " |",
               "|" + "|".join("---" for _ in head) + "|"]
        out += ["| " + " | ".join(map(str, r)) + " |" for r in rows]
        return "\n".join(out)
    return "\n".join(",".join(map(str, r)) for r in (head,) + tuple(rows))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    print(table(load_records(args.dir)))


if __name__ == "__main__":
    main()
