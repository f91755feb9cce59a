"""Resumable sweep checkpoints: one ``.npz`` shard per (config point,
instance range).

The port's copy of the reference ``utils/checkpoint.py``, with the same file
names and fields, so the port resumes from the reference's shards and the
reference from the port's. An interrupted sweep resumes by skipping the
shards on disk; each shard carries the per-instance arrays, so a partial
sweep stays auditable.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from byzantinerandomizedconsensus_tpu_torch.backends.base import SimResult
from byzantinerandomizedconsensus_tpu_torch.config import DEFAULT_ROUND_CAP, SimConfig


def shard_name(cfg: SimConfig, lo: int, hi: int) -> str:
    """The shard file of ``cfg``'s instances ``[lo, hi)``. Keys and the
    default round cap keep the legacy name; another delivery law, cap or
    spec §2 packing law is encoded, so a resumed sweep never reuses a shard
    drawn under different laws."""
    deliv = "" if cfg.delivery == "keys" else f"_{cfg.delivery}"
    cap = "" if cfg.round_cap == DEFAULT_ROUND_CAP else f"_c{cfg.round_cap}"
    pack = "" if cfg.pack_version == 1 else f"_p{cfg.pack_version}"
    return (f"{cfg.protocol}_n{cfg.n}_f{cfg.f}_{cfg.adversary}_{cfg.coin}"
            f"{deliv}{cap}{pack}_s{cfg.seed}_i{lo}-{hi}.npz")


def save_shard(out_dir: pathlib.Path, cfg: SimConfig, res: SimResult) -> pathlib.Path:
    """Write ``res`` as ``cfg``'s shard, published atomically: a partial
    write never counts as done."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lo, hi = int(res.inst_ids.min()), int(res.inst_ids.max()) + 1
    path = out_dir / shard_name(cfg, lo, hi)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp,
        inst_ids=res.inst_ids,
        rounds=res.rounds,
        decision=res.decision,
        config=np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8),
        wall_s=np.float64(res.wall_s),
    )
    tmp.rename(path)
    return path


def load_shard(path: pathlib.Path) -> SimResult:
    """A shard as a :class:`SimResult`; a config without the later fields
    (``faults``) takes their defaults."""
    data = np.load(path)
    cfg = SimConfig(**json.loads(bytes(data["config"]).decode()))
    return SimResult(
        config=cfg,
        inst_ids=data["inst_ids"],
        rounds=data["rounds"],
        decision=data["decision"],
        wall_s=float(data["wall_s"]),
    )


def have_shard(out_dir: pathlib.Path, cfg: SimConfig, lo: int, hi: int) -> bool:
    return (out_dir / shard_name(cfg, lo, hi)).exists()
