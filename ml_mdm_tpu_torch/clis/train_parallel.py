"""The training CLI of the port.

Counterpart of ``ml_mdm_tpu/clis/train_parallel.py``:

    python -m ml_mdm_tpu_torch.clis.train_parallel \\
        --config_path configs/models/cc12m_64x64.yaml --file-list <index.tsv> \\
        --text-model <local T5 directory> --fp16 1

reads the shards the index TSV lists through ``reader.
get_dataset_partition`` (one partition a process), embeds the captions with
the frozen text tower, and trains: each step runs the loss, the backward,
the clip, the NaN skip, Adam (AdamW with ``use_adamw``) and the EMA
(``trainer.make_train_step``). At ``--save-freq`` and at the last step it
writes ``vis_model_N.pth`` (the EMA), ``vis_model_noema_N.pth`` and the
train state ``train_state_N`` (``utils/checkpoint.py``). It resumes from a
``.pth`` (``--pretrained-vision-file``: the weights, ``batch_num`` and the
loss tracker's stats), or from a train state (``--resume-from-train-state``:
the exact state, that is parameters, EMA, Adam moments, step and the
step's noise seed; the data restarts from the shard's start, as in the JAX
CLI), optionally from its EMA weights (``--resume-from-ema``).

Differences from the JAX CLI, by design:

- parameters stay f32; ``--fp16 1`` sets the U-Net's compute dtype to bf16
  (``UNet.set_compute_dtype``), where the JAX CLI builds the module with
  ``dtype=bf16``. That is the route of the hand kernels (K1, K2, K3 and its
  passes). ``--fp16 0`` computes in f32, where the kernels, which take
  bf16, are switched off (``use_kernels(False)``): plain PyTorch;
- the weights come from the port's seeded init (``presets.build_unet``);
- the noise of step n on process r comes from a generator seeded by
  (seed, r, n), so a resumed run draws what an uninterrupted one would;
- data parallelism is one process a card (torchrun) with the gradients
  averaged by ``parallel.mesh.all_reduce_mean``; ``--mesh-shape
  data:D,fsdp:F`` shards the large parameters, their gradients, the EMA and
  the Adam moments over F processes with FSDP2 (``parallel.mesh.
  shard_module``; the JAX CLI builds the mesh and then replicates the whole
  state, ``ml_mdm_tpu/clis/train_parallel.py:203-209``), with the same
  arithmetic; a run of one process with an ``fsdp`` axis joins a process
  group of its own, so the sharded code runs there too. The checkpoints
  hold whole tensors either way;
- the JAX step is asynchronous and its metrics are read one step late;
  the port's step reads its loss and norm back (the NaN skip is a host
  check), and the metrics keep the JAX CLI's one-step-delayed ``consume``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ml_mdm_tpu_torch import helpers, reader, trainer
from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
from ml_mdm_tpu_torch.distributed import barrier, init_distributed_singlenode
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.parallel import (
    all_reduce_mean,
    broadcast_module,
    make_mesh,
    mesh_shape,
    shard_module,
)
from ml_mdm_tpu_torch.parallel.mesh import uses_fsdp
from ml_mdm_tpu_torch.presets import build_unet
from ml_mdm_tpu_torch.reader import convert
from ml_mdm_tpu_torch.trainer import RobustLossTracker, TrainerConfig, TrainState
from ml_mdm_tpu_torch.utils import checkpoint as ckpt
from ml_mdm_tpu_torch.utils import simple_logger


def load_batch(next_sample, language_model, tokenizer):
    """A reader batch made ready for the step: ``images`` (x - 127) / 128
    in NHWC f32, the watermark score as floats, the micro-conditioning
    ``scale`` from ``state``, and the frozen text tower's ``lm_outputs``
    and ``lm_mask`` (tensors on the tower's device)."""
    sample = dict(next_sample)
    if "image" in sample:
        sample["images"] = (sample["image"].astype(np.float32) - 127.0) / 128.0
    if "watermark_score" in sample:
        sample["watermark_score"] = np.asarray(
            [float(convert(w)) for w in sample["watermark_score"]], dtype=np.float32)
    if "state" in sample and "image" in sample:
        sample["scale"] = float(sample["image"].shape[1]) / sample["state"][:, 0]
    sample["lm_outputs"], sample["lm_mask"] = language_model(sample, tokenizer)
    return sample


def _device_batch(sample, pipeline, device):
    """The step's inputs on ``device``: images, the text and the
    micro-conditions the model reads; floats as f32."""
    keep = {"images", "lm_outputs", "lm_mask"} | set(pipeline.vision_module.conditions or {})
    out = {}
    for k, v in sample.items():
        if k in keep and v is not None:
            v = torch.as_tensor(v, device=device)
            out[k] = v.float() if v.is_floating_point() else v
    return out


def step_seed(seed: int, rank: int, batch_num: int) -> int:
    """The seed of the noise generator of step ``batch_num`` on process
    ``rank``."""
    return int(np.random.SeedSequence([seed, rank, batch_num]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def main(args, history=None):
    """Train as the arguments say; returns the final ``TrainState``. Given a
    list ``history``, each step's ``(batch_num, loss, grad_norm, step
    seconds)`` is appended to it as its metrics are consumed (the step
    seconds as the CLI's ``step time`` averages them)."""
    device = helpers.select_platform(args)
    local_rank, global_rank, world_size = init_distributed_singlenode(timeout=36000,
                                                                      device=device)
    if device.type == "cuda" and world_size > 1:
        device = torch.device("cuda", local_rank)
    # a spec that cannot be built raises before anything is loaded
    spec = getattr(args, "mesh_shape", None)
    shape = mesh_shape(spec, world_size)

    if world_size > 1 and not args.reader_config.pad_to_max_length:
        # the processes' batches must have one token length (the global
        # batch of the JAX CLI; here also one loss over equal shapes)
        if args.reader_config.max_token_length == -1:
            raise ValueError("multi-process training needs a static max_token_length")
        args.reader_config.pad_to_max_length = True
        logging.info("multi-process run: forcing reader pad_to_max_length so all "
                     "processes produce identically-shaped batches")

    seed = max(args.seed, 0)
    tokenizer, language_model = factory.create_lm(args, device, seed=seed)
    lm_dim = language_model.embed_dim

    args.unet_config.conditioning_feature_dim = lm_dim
    vision_module = build_unet(get_model(args.model), args.unet_config, device, seed,
                               dtype=torch.float32).train()
    if args.fp16:
        vision_module.set_compute_dtype(torch.bfloat16)
    elif device.type == "cuda":
        vision_module.use_kernels(False)  # the kernels take bf16 only
    logging.info(f"compute dtype {vision_module.dtype}, parameters "
                 f"{next(vision_module.parameters()).dtype}, on {device}"
                 f"{'' if args.fp16 or device.type != 'cuda' else ' (plain PyTorch: kernels off)'}")
    pipeline = get_pipeline(args.model)(vision_module, args.diffusion_config)

    if global_rank == 0 and args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    barrier("setup")

    n_params = sum(p.numel() for p in vision_module.parameters())
    logging.info(f"Model parameters: {n_params / 1e6:.2f}M ({n_params})")

    # the Matryoshka recipe: the inner U-Nets from their checkpoints before
    # the EMA copy is made, so both start from the loaded weights
    if hasattr(args.unet_config, "inner_config"):
        ckpt.apply_inner_warm_start(vision_module, args.unet_config)

    tracker = RobustLossTracker()
    start_batch_num = 0
    other_items = None
    if args.pretrained_vision_file:
        resume_path = ckpt.select_resume_checkpoint(args.pretrained_vision_file,
                                                    bool(getattr(args, "resume_from_ema", False)))
        if os.path.exists(resume_path):
            logging.info(f"Loading ckpt from {resume_path}")
            _, other_items = ckpt.load_vision_model(resume_path, vision_module)
    if other_items and "batch_num" in other_items:
        start_batch_num = int(other_items["batch_num"])
        tracker.load(float(other_items.get("exp_avg_loss", 0.0)),
                     float(other_items.get("exp_avg_loss_var", 0.0)),
                     float(other_items.get("best_avg_loss", 1e12)))
        logging.info(f"Loaded model. Batch #: {start_batch_num}")
    if world_size > 1:
        broadcast_module(vision_module)
    layout = None
    if uses_fsdp(spec):
        layout = shard_module(vision_module, make_mesh(shape, device))
        n_local = sum(layout.local(p).numel() for p in vision_module.parameters())
        logging.info(f"FSDP over a (data, fsdp) = {shape} mesh: {len(layout.dims)} of "
                     f"{len(list(vision_module.parameters()))} parameters sharded, "
                     f"{n_local} of {n_params} elements on this process")

    logger = None
    if global_rank == 0:
        logger = simple_logger.Logger(os.path.join(args.output_dir or ".", "train"),
                                      args.log_freq)
        try:
            logger.add_tensorboard_logger()
        except Exception as e:  # tensorboard is optional
            logging.warning(f"tensorboard unavailable: {e}")

    tcfg = TrainerConfig(
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        gradient_clip_norm=args.gradient_clip_norm,
        use_adamw=args.use_adamw,
        num_gradient_accumulations=args.num_gradient_accumulations,
        loss_factor=args.loss_factor,
        remat=bool(getattr(args, "remat", 0)),
    )
    freeze_mask = None
    if getattr(args.unet_config, "freeze_inner_unet", False):
        freeze_mask = {k: "freeze" if "inner_unet" in k.split(".") else "train"
                       for k, _ in vision_module.named_parameters()}
    state = TrainState.create(vision_module, tcfg, freeze_mask, layout)
    state.step = start_batch_num

    resume_dir = getattr(args, "resume_from_train_state", None)
    if resume_dir:
        # the exact state (parameters, EMA, optimizer state, step); the
        # reader starts again from the shard's first row, as in the JAX CLI
        state, other_items = ckpt.load_train_state(resume_dir, state)
        if getattr(args, "resume_from_ema", False):
            logging.info("--resume-from-ema: params <- ema_params")
            with torch.no_grad():
                for k, t in state.local_params().items():
                    t.copy_(state.ema_params[k])
        start_batch_num = int(state.step)
        if other_items:
            tracker.load(float(other_items.get("exp_avg_loss", 0.0)),
                         float(other_items.get("exp_avg_loss_var", 0.0)),
                         float(other_items.get("best_avg_loss", 1e12)))
        logging.info(f"Resumed the train state from {resume_dir} @ {start_batch_num}")

    # batch_size is per process, as in the JAX CLI and the reference's DDP
    logging.info(f"{'FSDP' if layout is not None else 'data parallel'} over {world_size} "
                 f"process(es), {args.batch_size * args.num_gradient_accumulations} rows each")
    train_step = trainer.make_train_step(pipeline, tcfg,
                                         all_reduce_mean if world_size > 1 else None)

    if args.multinode:
        partition_id, num_partitions = global_rank, world_size
    else:
        partition_id, num_partitions = local_rank, world_size
    train_loader = reader.get_dataset_partition(
        partition_id,
        num_partitions,
        tokenizer,
        args.batch_size * args.num_gradient_accumulations,
        args.file_list,
        args.reader_config,
        args.num_epochs,
        load_numpy=args.use_precomputed_text_embeddings,
        is_index_file=True,
    )
    data_iter = iter(train_loader)
    generator = torch.Generator(device=device)

    batch_num = start_batch_num
    total_time = 0.0
    num_time_counts = 0
    # the JAX CLI's one-step-delayed metrics: step N's are consumed after
    # step N + 1 is taken
    pending = None
    last_loss = float("nan")

    def consume(entry):
        """One step's metrics: the tracker and the logger."""
        nonlocal last_loss
        num, met, seconds = entry
        loss_val = float(met["loss"])
        last_loss = loss_val
        if history is not None:
            history.append((num, loss_val, float(met["grad_norm"]), seconds))
        if np.isnan(loss_val):
            return
        tracker.update(loss_val)
        if global_rank == 0 and logger is not None:
            logger.batch_num = num
            m = {
                "loss": loss_val,
                "batch_num": num,
                "exp_avg_loss": tracker.exp_avg_loss,
                "step time": total_time / max(num_time_counts, 1),
                "batch time": total_time / max(num - start_batch_num, 1),
                "exp_avg_std_loss": float(np.sqrt(tracker.exp_avg_loss_var)),
                "grad_norm": float(met["grad_norm"]),
            }
            for k_, v_ in m.items():
                logger.add_scalar(k_, v_)
            if num % args.log_freq == 0:
                logging.info(f"Batch: {num} - {m}")

    try:
        while batch_num < args.num_training_steps:
            try:
                raw = next(data_iter)
            except StopIteration:
                logging.info("data exhausted")
                break
            sample = load_batch(raw, language_model, tokenizer)
            if "images" not in sample:
                continue
            batch = _device_batch(sample, pipeline, device)

            start_time = time.time()
            generator.manual_seed(step_seed(seed, global_rank, batch_num))
            state, metrics = train_step(state, batch, generator)
            batch_num += 1
            if pending is not None:
                consume(pending)
            seconds = time.time() - start_time
            pending = (batch_num, metrics, seconds)
            total_time += seconds
            num_time_counts += 1

            if batch_num % args.save_freq == 0 or batch_num == args.num_training_steps:
                # saving needs this step's stats
                consume(pending)
                pending = None
                other = {
                    "batch_num": batch_num,
                    "loss": last_loss,
                    "best_avg_loss": tracker.best_avg_loss,
                    "exp_avg_loss": tracker.exp_avg_loss,
                    "exp_avg_loss_var": tracker.exp_avg_loss_var,
                }
                out = args.output_dir or "."
                # whole tensors (gathered under FSDP, where every process takes part)
                own = ckpt.module_state_dict(vision_module, layout)
                ema = ckpt.ema_state_dict(state)
                if global_rank == 0:
                    logging.info(f"Saving model. Batch = {batch_num}")
                    ckpt.save_vision_model(os.path.join(out, f"vis_model_{batch_num:06d}.pth"),
                                           {**own, **ema}, other_items=other)
                    ckpt.save_vision_model(
                        os.path.join(out, f"vis_model_noema_{batch_num:06d}.pth"),
                        own, other_items=other)
                del own, ema
                ckpt.save_train_state(os.path.join(out, f"train_state_{batch_num:06d}"),
                                      state, other_items=other, write_meta=global_rank == 0)
                barrier("save")

            if batch_num >= args.num_training_steps:
                break

        if pending is not None:
            consume(pending)
    finally:
        train_loader.close()
    logging.info(f"reader decodes: {train_loader.decodes}")
    if device.type == "cuda":
        local = sum(t.numel() * t.element_size() for t in state.local_params().values())
        logging.info(f"process {global_rank}: parameters {local} bytes on this process, peak "
                     f"device memory {torch.cuda.max_memory_allocated(device)} bytes")
    return state


if __name__ == "__main__":
    args = get_arguments(mode="trainer")
    logging.basicConfig(
        format="%(asctime)s,%(msecs)d %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S",
        level=getattr(logging, args.loglevel.upper(), None),
        force=True,  # get_arguments may have logged, which sets a default handler
    )
    seed = args.seed if args.seed != -1 else int(time.time() % 10000)
    logging.info(f"Using seed: {seed}")
    np.random.seed(seed)
    args.seed = seed
    helpers.print_args(args)
    main(args)
