"""Small helpers of the command-line entry points (``ml_mdm_tpu/helpers.py``)."""
import logging
import sys

import torch


def print_args(args):
    command_str = f"python {sys.argv[0]} "
    for k, v in vars(args).items():
        command_str += f"\\\n\t {k}={v}"
    logging.info(command_str)


def select_platform(args) -> torch.device:
    """The device ``args.device`` names. A CUDA device with no card present
    raises: the port never carries on on the CPU in its place."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is present "
                           "(pass --device cpu to run on the CPU)")
    return dev
