"""The port's 10k baseline on the reference's images, run from several trees.

    for c in 4649076 ff7a8f5 1a18e7d b2278ad; do
      mkdir -p build/bisect/$c
      git archive $c guidedvd3dgs_tpu_torch scripts/synthetic_reference_gt.py | tar -x -C build/bisect/$c
    done
    python scripts/baseline_bisect.py build/bisect/* [--iterations 10000] [--seed 1] [--jobs 4] \
        [--out build/bisect_logs]   (on a card)

Each argument is a directory that holds a tree's `guidedvd3dgs_tpu_torch/`
and `scripts/synthetic_reference_gt.py` (a `git archive` of a commit, or
one with a source swapped in). In each tree, with that tree's own code
and command lines, it writes the tool-default synthetic scene with the
reference's images (`synthetic_reference_gt.py`), trains `train_baseline`
for `--iterations` on its 6 train views at `--seed`, renders the test
views (`render --skip_train`) and scores them (`metrics`): the chain of
`guided_oracle_e2e.py`'s baseline, which the older trees lack. Trees run
`--jobs` at a time, each in its own processes; every kernel of the port
is deterministic, so the runs do not depend on one another.

It prints the card (nvidia-smi's name and power limit), then for each
tree the test PSNR / SSIM, the PSNR of each test view, the seconds of
each command, and hashes of the scene's images, of its init cloud (two
trees with equal hashes trained on the same scene) and of the trained
model's ply (equal hashes: the same bits); the last line is one JSON
object of these.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def _hash_files(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def run_tree(tree: Path, iters: int, seed: int, log_dir: Path) -> dict:
    """The chain in one tree; the logs go to `log_dir/<tree name>.log`."""
    tree = tree.resolve()
    work = tree / "bisect_run"
    scene, model = work / "scene", work / "model"
    py = sys.executable
    steps = [
        [py, "scripts/synthetic_reference_gt.py", "--out", str(scene), "--device", "cuda"],
        [py, "-m", "guidedvd3dgs_tpu_torch.train_baseline", "-s", str(scene), "-m", str(model),
         "--dataset", "colmap", "--n_views", "6", "--eval", "--iterations", str(iters),
         "--test_iterations", str(iters), "--save_iterations", str(iters), "--seed", str(seed),
         "--device", "cuda"],
        [py, "-m", "guidedvd3dgs_tpu_torch.render", "-m", str(model), "--skip_train"],
        [py, "-m", "guidedvd3dgs_tpu_torch.metrics", "-m", str(model)],
    ]
    log = log_dir / f"{tree.name}.log"
    rec = dict(tree=tree.name, seconds={})
    with open(log, "w") as f:
        for cmd in steps:
            name = cmd[1] if cmd[1] != "-m" else cmd[2].rsplit(".", 1)[-1]
            t0 = time.perf_counter()
            rc = subprocess.run(cmd, cwd=tree, stdout=f, stderr=subprocess.STDOUT).returncode
            rec["seconds"][name] = time.perf_counter() - t0
            if rc:
                rec["failed"] = f"{name} exited {rc}"
                return rec
    res = json.loads((model / "results.json").read_text())
    key = f"ours_{iters}" if f"ours_{iters}" in res else sorted(res)[-1]
    per_view = json.loads((model / "per_view.json").read_text())[key]["PSNR"]
    ply = model / "point_cloud" / f"iteration_{iters}" / "point_cloud.ply"
    rec.update(
        PSNR=res[key]["PSNR"], SSIM=res[key]["SSIM"],
        PSNR_per_view=[per_view[k] for k in sorted(per_view)],
        images_hash=_hash_files((scene / "images").iterdir()),
        init_cloud_hash=_hash_files([scene / "sparse" / "0" / "points3D.ply"]),
        model_hash=_hash_files([ply]) if ply.exists() else None,
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--iterations", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="build/bisect_logs")
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor(max_workers=a.jobs) as ex:
        recs = list(ex.map(lambda t: run_tree(Path(t), a.iterations, a.seed, out), a.trees))
    for r in recs:
        if "failed" in r:
            print(f"{r['tree']}: FAILED ({r['failed']}); log {out / (r['tree'] + '.log')}", flush=True)
            continue
        print(f"{r['tree']}: PSNR {r['PSNR']:.4f} SSIM {r['SSIM']:.5f} per view "
              + ", ".join(f"{x:.2f}" for x in r["PSNR_per_view"])
              + f"; images {r['images_hash']} cloud {r['init_cloud_hash']} model {r['model_hash']}; "
              + ", ".join(f"{k} {v:.1f} s" for k, v in r["seconds"].items()), flush=True)
    print(json.dumps(dict(card=card, iterations=a.iterations, seed=a.seed, runs=recs)))
    if any("failed" in r for r in recs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
