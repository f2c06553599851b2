"""The selective scan's share of its byte roofline, in
falcon-mamba-7b.train-4x4096: the family's ``scan_bytes`` a step at the
card's memory bandwidth over ``ssm_scan_ms.mamba``."""
import json
import pathlib
from typing import Dict, Optional

from perfbench import flops
from perfbench.families import mamba1

HERE = pathlib.Path(__file__).resolve().parent.parent
CELL = ("falcon-mamba-7b", "train-4x4096")


def read(obs: Dict) -> Optional[float]:
    ms = mamba1.scan_ms(obs)
    bw = flops.peak(obs["device_kind"], "hbm_bytes_per_s")
    if ms is None or bw is None:
        return None
    conf = json.loads((HERE / "configs" / f"{CELL[0]}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{CELL[1]}.json").read_text())
    least = mamba1.scan_bytes(conf, mix["batch"], mix["seq_len"])
    return 100.0 * (least / bw) / (ms / 1e3)
