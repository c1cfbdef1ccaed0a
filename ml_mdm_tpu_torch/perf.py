"""The port's performance-path gates (counterpart of ``ml_mdm_tpu/perf.py``).

| Field (env var)                                | Default | Gates |
|------------------------------------------------|---------|-------|
| flash (ML_MDM_TPU_FLASH)                       | 0       | unmasked attention with lengths that are multiples of 128 goes through the hand-written flash kernel (``ops/attention.py`` ``flash_attention``, K4) in place of the matmul route; forward only. In a sampling ``SelfAttention`` on the card K4 then takes the self branch and K6 the text branch. ``ops.attention.use_flash`` overrides it in code. |
| bf16_logits (ML_MDM_TPU_BF16_LOGITS)           | 1       | the matmul route rounds the attention logits to bf16 under bf16 compute (0: keeps them in f32). Off the flash route the matmul route's definition holds on every path: the two ``torch.matmul`` calls around an f32 softmax, or, in a sampling ``SelfAttention`` on the card (bf16, no gradient), both branches in one launch of K6 (``ops/attention.py`` ``two_branch_attention``), which never writes the logits to memory. |
| fused_pipelined (ML_MDM_TPU_FUSED_PIPELINED)   | 1       | packed K2 launches with at least ``PIPELINE_MIN_CHUNKS`` channel chunks and ``PIPELINE_MIN_TILES`` output tiles (``ops/fused_resnet.py`` ``pipelines``) count as the software-pipelined variant (K2·pipe); the kernel overlaps the next chunk's loads with this chunk's products at every launch, so the gate changes no result. |
| pack64_min_side (ML_MDM_TPU_PACK64_MIN_SIDE)   | 256     | least image side at which a stage of at most 64 channels runs space-to-depth packed (stages of at most 32 channels pack from the U-Net config's ``pack_min_side``; ``models/layers.py`` ``ResNetBlockStage.packs_at``). |
| pack_max_ch (ML_MDM_TPU_PACK_MAX_CH)           | 64      | the widest stage that may pack (32: only the 32-channel stages). |

The names and defaults are the JAX package's, so one environment variable
sets both packages in a test. The environment is read at every call.
Packing is off for a model whose config has ``pack_min_side = 0``.

The JAX package declares more gates, which the port does not carry:
``fused``, ``fused_train``, ``fused_min_side``, ``fused_proj``,
``gn_kernel`` and ``vjp_chain_bf16_min_side`` switch the Pallas kernels by
TPU measurements; the port runs its hand kernels on every CUDA tensor
(``UNet.use_kernels(False)`` picks the plain versions), and any gate of its
own waits for the H100's numbers. ``wcache`` hoists packed-weight
transforms out of a jitted denoise scan; the port, which runs eagerly,
keeps them on the module with gradients off instead (``models/layers.py``
``cached_weights``), with no gate. The JAX ``resolve_kernel_mode``, where
the value "1" forces the TPU kernel on any backend, has no counterpart
here: a wrapper picks its kernel by the device of the tensor it is given.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    flash: bool = False
    bf16_logits: bool = True
    fused_pipelined: bool = True
    pack64_min_side: int = 256
    pack_max_ch: int = 64


def perf() -> PerfConfig:
    """The effective gates: the defaults overridden by the environment."""
    d = PerfConfig()
    return PerfConfig(
        flash=os.environ.get("ML_MDM_TPU_FLASH", "0") == "1",
        bf16_logits=os.environ.get("ML_MDM_TPU_BF16_LOGITS", "1") != "0",
        fused_pipelined=os.environ.get("ML_MDM_TPU_FUSED_PIPELINED", "1") != "0",
        pack64_min_side=int(os.environ.get("ML_MDM_TPU_PACK64_MIN_SIDE", d.pack64_min_side)),
        pack_max_ch=int(os.environ.get("ML_MDM_TPU_PACK_MAX_CH", d.pack_max_ch)),
    )
