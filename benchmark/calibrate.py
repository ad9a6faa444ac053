"""The readings that the limits of ``correct`` are set from, at a cell's
own sizes, in one process:

- the program's, over many seeds (its checked steps or sampled answers
  against the reference, as a run reads them);
- the control's: the reference in the program's place, one precision
  below the configuration's (``reference/quant.py``);
- the entry's planted faults (its ``FAULTS``), in the reference put in
  the program's place: for training cells half the batch left out, the
  mean taken over the rest (a state left unchanged reads 1 on
  ``change_gap`` and needs no run), for the self-supervised cell also the
  pseudo-GT moved by 30 mm where it is produced, for the eval cell a
  flip test that does not shift or does not swap.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 \
        --out calibrate_<cell>.json
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import quant  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def program(spec, name, seed, device) -> dict:
    ctx, entry = harness.make_ctx(spec, name, seed, device)
    job = entry.Job(ctx)
    if entry.KIND == "eval":
        for i in range(int(ctx.cell["check"]["batches"])):
            job.after(i, job.call(i))
    readings, notes = job.check()
    return dict(readings, notes=notes)


def control(spec, name, seed, device) -> dict:
    ctx, entry = harness.make_ctx(spec, name, seed, device)
    kwargs = {"quant": quant.FP8}
    if ctx.cell["entry"] == "ss_train":
        kwargs["tri_round"] = quant.tf32
    readings, notes = entry.stand_in(ctx, **kwargs)
    return dict(readings, notes=notes)


def faults(spec, name, seed, device) -> dict:
    """Each of the entry's planted faults (``FAULTS``)."""
    ctx, entry = harness.make_ctx(spec, name, seed, device)
    out = {}
    for fault in entry.FAULTS:
        readings, notes = entry.stand_in(ctx, fault=fault)
        out[fault] = dict(readings, notes=notes)
        torch.cuda.empty_cache()
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    spec = Spec()
    dev = torch.device("cuda", 0)
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {},
           "device": torch.cuda.get_device_name(dev),
           "power_limit_w": harness.power_limit_w()}

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    t0 = time.perf_counter()
    for key, fn, ss in (("program", program, seeds(args.seeds)),
                        ("control", control, seeds(args.control_seeds)),
                        ("faults", faults, seeds(args.fault_seeds))):
        for s in ss:
            out[key][s] = fn(spec, args.workload, s, dev)
            torch.cuda.empty_cache()
            print(key, s, json.dumps(out[key][s]),
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
