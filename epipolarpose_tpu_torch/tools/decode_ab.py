"""The host decode of two checkouts, measured against each other on one host.

    python -m epipolarpose_tpu_torch.tools.decode_ab --trees OLD NEW \\
        [--order ABBA] [--reps 40] [--out output/decode_ab]

Each tree is a checkout of this repo (``git archive`` of a commit, say),
measured by its own code: its package and its ``chip_smoke.py``.

- ms a decode, one thread, of the repo's dataset frames at 8/8 and 2/8
  (``tests/data/jpeg``: the 2048 x 2048 and 1920 x 1080 3DHP frames, the
  1000 x 1000 H36M frame, the progressive 2048 x 2048 twin) through each
  tree's ``jpeg.decode``: one process a tree, both alive, asked in turn
  (A then B, then B then A, ...) for one decode each, ``--reps`` rounds
  after one; median and min of each;
- then for each letter of ``--order`` (A the first tree, B the second) a
  fresh process runs that tree's ``chip_smoke.native_valid`` twice and
  reads the second (the first builds the native loader and tunes cuDNN):
  the 3DHP tree of 2048 x 2048 and 1920 x 1080 frames through the
  ``valid`` CLI at ResNet-50@256 with ``TPU.NATIVE_LOADER`` true and
  false, samples/s of each, and the native loader alone at ``scale_num``
  2/8 (img/s), with one random-weight checkpoint (seed 0) for both trees.

A drift of the host's speed falls on both trees alike in the first part,
and shows as a difference between a tree's two runs in the second. It
needs a CUDA card (the ``valid`` CLI runs the model there). Prints one
line a measurement and, last, a JSON object of them all; ``--out`` gets
each process's log.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

FRAMES = ("3dhp_studio_2048x2048.jpg", "3dhp_outdoor_1920x1080.jpg",
          "h36m_1000x1000.jpg", "3dhp_studio_progressive_2048x2048.jpg")
# 8/8, and 2/8 (what the native loader picks for real 3DHP boxes)
SCALES = (8, 2)
CONFIG = "h36m/valid_3dhp_transfer.yaml"

# one decode a line of stdin ("<fixture> <scale_num>"), its ms on stdout;
# argv is the tree, whose package alone is on the path
DECODER = r"""
import pathlib, sys, time
tree = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(tree))
from epipolarpose_tpu_torch.data import jpeg
bufs = {}
for line in sys.stdin:
    name, scale = line.split()
    if name not in bufs:
        bufs[name] = (tree / "tests" / "data" / "jpeg" / name).read_bytes()
    t = time.perf_counter()
    jpeg.decode(bufs[name], int(scale))
    print((time.perf_counter() - t) * 1e3, flush=True)
"""

# the valid runs, from the tree's root; argv is the tree and the checkpoint
VALID = r"""
import json, logging, pathlib, sys
tree, weights = pathlib.Path(sys.argv[1]), sys.argv[2]
sys.path.insert(0, str(tree))
import torch
torch.cuda.set_device(0)
logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="%(message)s")
import chip_smoke as cs
res = {"paths": {}, "cli_fs_final": weights}
cs.native_valid(res)            # builds the loader, tunes cuDNN: not kept
v = cs.native_valid(res)
print("RESULT " + json.dumps(dict(
    native_valid=v["native_valid"]["samples_per_s"],
    pool_valid=v["pool_valid"]["samples_per_s"],
    native_decode_share=v["native_valid"]["shares"]["host"]["upstream_wait_s"],
    boxes_x3_img_s=v["boxes_x3"]["img_s"],
    boxes_x3_scales=v["boxes_x3"]["scales"])), flush=True)
"""


def _env(tree: pathlib.Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(tree))


def decode_rounds(trees: dict, reps: int) -> dict:
    """ms a decode of each of FRAMES at each of SCALES by each tree,
    interleaved; keyed ``<frame>@<scale_num>/8``."""
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", DECODER, str(t)], cwd=t, env=_env(t),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for k, t in trees.items()}

    def one(letter: str, name: str) -> float:
        p = procs[letter]
        p.stdin.write(name.replace("@", " ").split("/")[0] + "\n")
        p.stdin.flush()
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(f"tree {letter}'s decoder exited "
                               f"({p.poll()}) on {name}")
        return float(line)

    out = {k: {} for k in trees}
    try:
        for name in (f"{f}@{s}/8" for f in FRAMES for s in SCALES):
            times = {k: [] for k in trees}
            for k in trees:
                one(k, name)                            # warm-up
            for i in range(reps):
                for k in (sorted(trees) if i % 2 == 0
                          else sorted(trees, reverse=True)):
                    times[k].append(one(k, name))
            for k, ts in times.items():
                ts.sort()
                out[k][name] = dict(median=ts[len(ts) // 2], min=ts[0])
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=60)
    return out


def random_checkpoint(path: pathlib.Path) -> None:
    """ResNet-50@256 of the 3DHP valid config, seed 0, as a ``.pth.tar``."""
    import torch
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.models import get_model
    root = pathlib.Path(__file__).resolve().parents[2]
    cfg = load_config(root / "experiments" / CONFIG)
    torch.manual_seed(0)
    model = get_model(cfg, False)
    torch.save({"state_dict": model.state_dict()}, path)


def run_valid(tree: pathlib.Path, weights: pathlib.Path,
              log: pathlib.Path | None) -> dict:
    r = subprocess.run([sys.executable, "-c", VALID, str(tree), str(weights)],
                       cwd=tree, env=_env(tree), capture_output=True,
                       text=True, timeout=900)
    if log is not None:
        log.write_text(r.stdout + "\n--- stderr\n" + r.stderr)
    found = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode != 0 or not found:
        raise RuntimeError(f"{tree}: rc {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(found[-1][len("RESULT "):])


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs=2, required=True, type=pathlib.Path)
    p.add_argument("--order", default="ABBA")
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--out", type=pathlib.Path, default=None)
    args = p.parse_args(argv)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    trees = {"A": args.trees[0].resolve(), "B": args.trees[1].resolve()}
    ms = decode_rounds(trees, args.reps)
    for k in sorted(trees):
        print(f"tree {k}: ms a decode (median / min of {args.reps}, "
              f"interleaved) " + ", ".join(
                  f"{n} {v['median']:.2f} / {v['min']:.2f}"
                  for n, v in ms[k].items()), flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="epk_decode_ab_") as tmp:
        weights = pathlib.Path(tmp) / "random_r50_256.pth.tar"
        random_checkpoint(weights)
        for i, letter in enumerate(args.order):
            log = (None if args.out is None
                   else args.out / f"run{i + 1}_{letter}.log")
            r = run_valid(trees[letter], weights, log)
            r.update(run=i + 1, tree=letter)
            runs.append(r)
            print(f"run {i + 1} tree {letter}: 3DHP valid native "
                  f"{r['native_valid']:.1f} samples/s (decode "
                  f"{r['native_decode_share']:.1%}), pool "
                  f"{r['pool_valid']:.1f}; loader alone, boxes x3 "
                  f"{r['boxes_x3_img_s']:.1f} img/s at {r['boxes_x3_scales']}",
                  flush=True)
    out = dict(trees={k: str(v) for k, v in trees.items()}, ms=ms,
               valid=runs)
    print(json.dumps({"decode_ab": out}))
    return out


if __name__ == "__main__":
    main()
