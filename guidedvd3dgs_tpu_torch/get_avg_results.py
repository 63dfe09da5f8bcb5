"""Average each scene's results.json over a dataset's fixed scene list.

The port's copy of the reference package's root `get_avg_results.py` (the
reference's get_avg_results_replica.py / _scannetpp.py), with the same
scene lists, flags and output, `<root>/<model_path>/results_allscenes.json`:

    python -m guidedvd3dgs_tpu_torch.get_avg_results -m <exp_name> --dataset replica|scannetpp
        [--iteration 10000] [--root ./output/]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from typing import List, Optional

import numpy as np

SCENES = {
    "replica": [
        "office_2/Sequence_2", "office_3/Sequence_1", "office_4/Sequence_2",
        "room_0/Sequence_2", "room_1/Sequence_1", "room_2/Sequence_1",
    ],
    "scannetpp": ["8a20d62ac0", "94ee15e8ba", "7831862f02", "a29cccc784"],
}


def evaluate(model_path: str, dataset: str, iteration: int = 10_000, root: str = "./output/") -> dict:
    """Per-scene PSNR, SSIM, LPIPS and LPIPS_ALEX lists and their means
    (`<metric>_all`, over the scenes that have the metric; None where none
    has it)."""
    results = {"psnr": [], "ssim": [], "lpips": [], "lpips_alex": []}
    root_dir = os.path.join(root, model_path)
    for scene in SCENES[dataset]:
        with open(os.path.join(root_dir, scene, "results.json")) as f:
            r = json.load(f)[f"ours_{iteration}"]
        results["psnr"].append(r["PSNR"])
        results["ssim"].append(r["SSIM"])
        results["lpips"].append(r.get("LPIPS"))
        results["lpips_alex"].append(r.get("LPIPS_ALEX", r.get("LPIPS_alex")))
    for k, v in list(results.items()):
        have = [x for x in v if x is not None]
        results[k + "_all"] = float(np.mean(have)) if have else None
    print(results)
    with open(os.path.join(root_dir, "results_allscenes.json"), "w") as fp:
        json.dump(results, fp, indent=True)
    return results


def main(argv: Optional[List[str]] = None) -> dict:
    parser = ArgumentParser(description="Avg")
    parser.add_argument("--model_path", "-m", required=True, type=str)
    parser.add_argument("--dataset", choices=list(SCENES), default="replica")
    parser.add_argument("--iteration", type=int, default=10_000)
    parser.add_argument("--root", type=str, default="./output/")
    args = parser.parse_args(argv)
    return evaluate(args.model_path, args.dataset, args.iteration, args.root)


if __name__ == "__main__":
    main()
