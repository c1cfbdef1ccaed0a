"""The port's performance-path gates (counterpart of ``ml_mdm_tpu/perf.py``).

| Field (env var)                        | Default | Gates |
|----------------------------------------|---------|-------|
| flash (ML_MDM_TPU_FLASH)               | 0       | unmasked attention with lengths that are multiples of 128 goes through the hand-written flash kernel (``ops/attention.py`` ``flash_attention``, K4) in place of the two ``torch.matmul`` calls; forward only. ``ops.attention.use_flash`` overrides it in code. |
| bf16_logits (ML_MDM_TPU_BF16_LOGITS)   | 1       | the matmul route stores the attention logits in bf16 under bf16 compute (0: in f32). |

The environment is read at every call, so a test can change it.

The JAX package declares more gates, which the port does not carry:
``fused``, ``fused_train``, ``fused_min_side``, ``fused_proj``,
``fused_pipelined``, ``gn_kernel`` and ``vjp_chain_bf16_min_side`` switch
the Pallas kernels by TPU measurements; the port runs its hand kernels on
every CUDA tensor (``UNet.use_kernels(False)`` picks the plain versions),
and any gate of its own waits for the H100's numbers. ``pack64_min_side``,
``pack_max_ch`` and ``wcache`` belong to space-to-depth packing, which the
port does not have. The JAX ``resolve_kernel_mode``, where the value "1"
forces the TPU kernel on any backend, has no counterpart here: a wrapper
picks its kernel by the device of the tensor it is given.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    flash: bool = False
    bf16_logits: bool = True


def perf() -> PerfConfig:
    """The effective gates: the defaults overridden by the environment."""
    return PerfConfig(
        flash=os.environ.get("ML_MDM_TPU_FLASH", "0") == "1",
        bf16_logits=os.environ.get("ML_MDM_TPU_BF16_LOGITS", "1") != "0",
    )
