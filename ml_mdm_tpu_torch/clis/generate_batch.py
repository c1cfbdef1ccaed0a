"""Evaluation samples from a checkpoint: the port's ``generate_batch``.

Counterpart of ``ml_mdm_tpu/clis/generate_batch.py``:

    python -m ml_mdm_tpu_torch.clis.generate_batch --config_path <yaml> \\
        --model-file vis_model_N.pth --test-file-list <index.tsv> --text-model <T5 dir>

Each process reads its partition of ``--test-file-list`` until
``min_examples / world_size`` samples are cached (tokens, captions, the
reference images and the text tower's features, kept on the host), writes
the reference images ``ref_N.png``, a caption manifest ``rank<r>/lst.json``
and, on rank 0, the gallery ``index.html``; then it denoises each cached
batch (classifier-free guidance with the negative prompt's rows spliced in
as the unconditional ones when ``guidance_scale != 1``), writes
``s_N.png`` and the manifest of the samples. The last batch may be short.

``chunk_steps`` is accepted and unused: the port's ``sample_chunked`` is
``sample``. As the JAX CLI fans one process's batch out over the devices
it sees, a process that sees more than one card (a run of one process on
a machine of several) samples each batch whose size their count divides
through ``parallel.make_data_parallel_sampler`` (one replica of the model
a card, the rows split over them, the same images as one card); otherwise
a batch runs on the process's one card.
"""
from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ml_mdm_tpu_torch import generate_html, helpers, parallel, reader
from ml_mdm_tpu_torch.config import get_arguments, get_model, get_pipeline
from ml_mdm_tpu_torch.distributed import barrier, init_distributed_singlenode
from ml_mdm_tpu_torch.language_models import factory
from ml_mdm_tpu_torch.presets import build_unet
from ml_mdm_tpu_torch.reader import convert, process_text
from ml_mdm_tpu_torch.utils import checkpoint as ckpt


def save_png(arr_m1_1: np.ndarray, path: str):
    """[-1, 1] float HWC -> PNG (x * 128 + 127, clipped)."""
    from PIL import Image

    img = np.clip(np.asarray(arr_m1_1, dtype=np.float32) * 128.0 + 127.0, 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path)


def generate_data(args, tokenizer, language_model, num_examples: int, negative_prompt=None,
                  rank: int = 0, world: int = 1):
    """Cache (captions, tokens, text features, reference images) of
    partition ``rank`` of ``world`` of the eval set until ``num_examples``
    samples; with ``negative_prompt`` the tokens are its rows then the
    captions', padded to one length."""
    loader = reader.get_dataset_partition(
        rank, world, tokenizer, args.batch_size, args.test_file_list, args.reader_config,
        num_epochs=1, is_index_file=True)
    cached = []
    total = 0
    try:
        for sample in loader:
            captions = [convert(c) for c in sample["caption"]]
            if negative_prompt is not None:
                neg_tokens = process_text([negative_prompt] * len(captions), tokenizer,
                                          args.reader_config)
                pos_tokens = [list(t) for t in sample["tokens"]]
                max_len = max(max(len(t) for t in neg_tokens), max(len(t) for t in pos_tokens))
                pad = tokenizer.token_id(args.reader_config.padding_token)

                def pad_to(ts):
                    return np.asarray([t + [pad] * (max_len - len(t)) for t in ts],
                                      dtype=np.int64)

                tokens = np.concatenate([pad_to(neg_tokens), pad_to(pos_tokens)], axis=0)
            else:
                tokens = sample["tokens"]
            lm_outputs, lm_mask = language_model({"tokens": tokens}, tokenizer)
            cached.append({
                "captions": captions,
                "tokens": tokens,
                "lm_outputs": lm_outputs.cpu(),
                "lm_mask": None if lm_mask is None else lm_mask.cpu(),
                "image": sample.get("image"),
            })
            total += len(captions)
            if total >= num_examples:
                break
    finally:
        loader.close()
    return cached


def local_devices(device: torch.device, world_size: int):
    """The devices one process samples on: every card when a CUDA process
    runs alone, else its own device."""
    if device.type == "cuda" and world_size == 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def main(args, negative_prompt=None, guidance_scale=1.0, ddim_eta=None,
         num_inference_steps=None, chunk_steps=None, times=None):
    """Write the reference images, the samples, ``lst.json`` and
    ``index.html``; returns the number of samples. Given a list ``times``,
    each batch's sampling seconds (the denoising loop and the copy of its
    images to the host) are appended to it."""
    device = helpers.select_platform(args)
    local_rank, global_rank, world_size = init_distributed_singlenode(device=device)
    if device.type == "cuda" and world_size > 1:
        device = torch.device("cuda", local_rank)
    seed = max(args.seed, 0)
    tokenizer, language_model = factory.create_lm(args, device, seed=seed)
    args.unet_config.conditioning_feature_dim = language_model.embed_dim
    # bf16 on the card (the kernels' type), f32 on the CPU unless --fp16
    dtype = torch.bfloat16 if (device.type == "cuda" or args.fp16) else torch.float32
    vision_module = build_unet(get_model(args.model), args.unet_config, device, seed,
                               dtype=dtype)
    pipeline = get_pipeline(args.model)(vision_module, args.diffusion_config)

    sample_dir = args.sample_dir
    rank_dir = os.path.join(sample_dir, f"rank{global_rank}")
    os.makedirs(rank_dir, exist_ok=True)

    num_examples = max(args.min_examples // max(world_size, 1), 1)
    use_cfg = guidance_scale != 1.0
    cached = generate_data(args, tokenizer, language_model, num_examples,
                           negative_prompt if use_cfg else None, global_rank, world_size)

    # the reference images, their manifest and the gallery
    caption_lst = []
    idx = 0
    for batch in cached:
        for i, cap in enumerate(batch["captions"]):
            if batch["image"] is not None:
                fname = os.path.join(rank_dir, f"ref_{idx:06d}.png")
                save_png((batch["image"][i].astype(np.float32) - 127.0) / 128.0, fname)
                caption_lst.append((fname, cap))
            idx += 1
    with open(os.path.join(rank_dir, "lst.json"), "w") as f:
        json.dump({f"s_{i:06d}.png": c for i, (_, c) in enumerate(caption_lst)}, f)
    if global_rank == 0:
        generate_html.create_html(os.path.join(sample_dir, "index.html"), len(caption_lst),
                                  caption_lst)

    image_side = (args.sample_image_size if args.sample_image_size > 0
                  else (args.reader_config.image_size or 64))
    barrier("pre-load")
    if args.model_file:
        ckpt.load_vision_model(args.model_file, vision_module)
    barrier("post-load")

    sample_kwargs = {}
    if num_inference_steps:
        sample_kwargs = dict(num_inference_steps=num_inference_steps, resample_steps=True)
    if ddim_eta is not None:
        sample_kwargs["ddim_eta"] = ddim_eta

    generator = torch.Generator(device=device).manual_seed(seed)
    devices = local_devices(device, world_size)
    samplers = {}
    out_idx = 0
    manifest = {}
    for batch in cached:
        b = len(batch["captions"])
        cond = {"lm_outputs": batch["lm_outputs"].to(device),
                "lm_mask": None if batch["lm_mask"] is None else batch["lm_mask"].to(device)}
        t0 = time.perf_counter()
        if len(devices) > 1 and b % len(devices) == 0:
            if b not in samplers:
                logging.info(f"batch {b}: data parallel over {len(devices)} devices")
                samplers[b] = parallel.make_data_parallel_sampler(
                    pipeline, b, image_side, devices, guidance_scale=guidance_scale,
                    **sample_kwargs)
            out = samplers[b](cond, generator)
        else:
            out = pipeline.sample(b, cond, image_side, generator, guidance_scale=guidance_scale,
                                  **sample_kwargs)
        out = out.clamp(-1, 1).float().cpu().numpy()
        if times is not None:
            times.append(time.perf_counter() - t0)
        for i, cap in enumerate(batch["captions"]):
            fname = f"s_{out_idx:06d}.png"
            save_png(out[i], os.path.join(rank_dir, fname))
            manifest[fname] = cap
            out_idx += 1
    with open(os.path.join(rank_dir, "lst.json"), "w") as f:
        json.dump(manifest, f)
    logging.info(f"rank {global_rank}: wrote {out_idx} samples")
    return out_idx


if __name__ == "__main__":
    args = get_arguments(mode="sampler")
    logging.basicConfig(
        format="%(asctime)s,%(msecs)d %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S",
        level=getattr(logging, args.loglevel.upper(), None),
        force=True,  # get_arguments may have logged, which sets a default handler
    )
    seed = args.seed if args.seed != -1 else int(time.time() % 10000)
    np.random.seed(seed)
    args.seed = seed
    helpers.print_args(args)
    main(args)
