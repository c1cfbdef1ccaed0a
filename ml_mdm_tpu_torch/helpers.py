"""Small helpers of the command-line entry points (``ml_mdm_tpu/helpers.py``)."""
import logging
import sys

import torch


def print_args(args):
    command_str = f"python {sys.argv[0]} "
    for k, v in vars(args).items():
        command_str += f"\\\n\t {k}={v}"
    logging.info(command_str)


def reproducible() -> None:
    """The seed contract: on one device, the same inputs, noise and seed
    give the same bits from call to call and from process to process, as
    in the JAX package. The port's own kernels take every sum in a fixed
    order; this asks cuDNN (the plain convolutions, K3's weight gradient)
    for deterministic algorithms only. A process-wide setting, made where
    the entry points start (the CLIs and the demo's server through
    ``select_platform``, ``Diffusion.sample`` and its siblings,
    ``get_loss``, ``trainer.make_train_step``), so a library caller gets
    the same guarantee as a CLI user; it costs well under a microsecond.
    Bits may differ between batch sizes (cuBLAS and cuDNN choose by shape)
    and where the caller turns ``torch.backends.cudnn.benchmark`` on."""
    torch.backends.cudnn.deterministic = True


def select_platform(args) -> torch.device:
    """The device ``args.device`` names, under the seed contract
    (``reproducible``). A CUDA device with no card present raises: the port
    never carries on on the CPU in its place."""
    reproducible()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is present "
                           "(pass --device cpu to run on the CPU)")
    return dev
