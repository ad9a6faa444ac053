"""Run directories, logging and the metric writer.

Counterpart of the JAX package's ``core/logger.py``: the run's output
directory ``<OUTPUT_DIR>/<dataset>/<full_name>/<cfg_name>/`` with its
timestamped log file, the log directory ``<LOG_DIR>/<dataset>/
<cfg_name>_<time>/``, and a tensorboard writer when one can be made.
Under data parallelism only the first process makes the directories,
writes the log file and gets a writer; the others log to stderr.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

from epipolarpose_tpu_torch.config import get_model_name
from epipolarpose_tpu_torch.parallel.mesh import process_index


def create_logger(cfg, cfg_name: str, phase: str = "train"):
    """Make the run's directories and send the root logger to the log file
    and the console. Returns (logger, final_output_dir, tb_log_dir). A
    process other than the first makes nothing and logs to stderr, each
    line marked with its rank."""
    root = Path(cfg.OUTPUT_DIR)
    dataset = cfg.DATASET.DATASET
    _, full_name = get_model_name(cfg)
    cfg_name = os.path.basename(cfg_name).split(".")[0]

    final_output_dir = root / dataset / full_name / cfg_name
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    tb_log_dir = Path(cfg.LOG_DIR) / dataset / f"{cfg_name}_{time_str}"
    rank = process_index()
    if rank != 0:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO, force=True,
            format=f"%(asctime)-15s [rank {rank}] %(message)s")
        return logging.getLogger(), str(final_output_dir), str(tb_log_dir)
    final_output_dir.mkdir(parents=True, exist_ok=True)

    log_file = final_output_dir / f"{cfg_name}_{time_str}_{phase}.log"
    logging.basicConfig(
        filename=str(log_file),
        format="%(asctime)-15s %(message)s",
        level=logging.INFO,
        force=True)
    logger = logging.getLogger()
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
    logger.addHandler(console)
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


def create_metric_writer(tb_log_dir: str):
    """A ``torch.utils.tensorboard.SummaryWriter`` into ``tb_log_dir``, or
    None when tensorboard is not installed (the loops then write no
    scalars), as the JAX package's writer is None without it, and on a
    process other than the first."""
    if process_index() != 0:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(tb_log_dir)
