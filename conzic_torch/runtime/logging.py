"""Run logging with the reference's console and per-run file scheme.

Counterpart of ``conzic_tpu/runtime/logging.py``: the same logger layout
(a message-only file handler and a console handler), the same file names
encoding the run's hyperparameters, and the same run labels, so that two
runs' log lines compare as text. colorlog is used when it is installed.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from conzic_torch.config import ConzicConfig


def create_logger(folder: str, filename: str) -> logging.Logger:
    os.makedirs(folder, exist_ok=True)
    logger = logging.getLogger("conzic_torch")
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:  # close the previous run's file handler
        h.close()
    logger.handlers = []
    try:
        import colorlog

        stream = logging.StreamHandler()
        stream.setFormatter(colorlog.ColoredFormatter(""))
    except ImportError:
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter("%(message)s"))
    stream.setLevel(logging.DEBUG)
    file_handler = logging.FileHandler(os.path.join(folder, filename))
    file_handler.setLevel(logging.DEBUG)
    file_handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(file_handler)
    logger.addHandler(stream)
    logger.propagate = False
    return logger


def run_type_label(cfg: ConzicConfig) -> str:
    """'caption', 'pos', or the sentiment polarity: the run label of log
    file names, console lines and result directories."""
    run_type = "caption" if cfg.run_type == "caption" else cfg.control_type
    if run_type == "sentiment":
        run_type = cfg.sentiment_type
    return run_type


def run_log_filename(cfg: ConzicConfig, prefix: Optional[str] = None) -> str:
    """'{run type}_{order}_len..._{timestamp}.log'."""
    run_type = run_type_label(cfg)
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime())
    name = (
        f"{run_type}_{cfg.order}_len{cfg.sentence_len}_topk{cfg.candidate_k}"
        f"_alpha{cfg.alpha}_beta{cfg.beta}_gamma{cfg.gamma}"
        f"_lmtemp{cfg.lm_temperature}_{stamp}.log"
    )
    return f"{prefix}_{name}" if prefix else name


def null_logger() -> logging.Logger:
    logger = logging.getLogger("conzic_torch_null")
    logger.handlers = [logging.NullHandler()]
    logger.propagate = False
    return logger
