"""CC12M acquisition: ``img2dataset`` downloads the URL list into webdataset
tar shards, each shard's parquet becomes a TSV of (tar, file, caption) rows,
and the shard TSVs are split into a training and a validation index.

The port's own copy of ``ml_mdm_tpu/clis/scrape_cc12m.py``. The download
needs ``img2dataset`` and a network, and raises without the package; the
conversion (pandas, imported when it runs) and the split work on shards
already downloaded, so the indexes can be rebuilt offline.

    python -m ml_mdm_tpu_torch.clis.scrape_cc12m --output-dir cc12m --stage convert
"""
from __future__ import annotations

import argparse
import glob
import logging
import os


def download(tsv_url_list: str, output_dir: str, image_size: int = 256,
             processes: int = 16, threads: int = 64):
    try:
        from img2dataset import download as i2d_download
    except ImportError as e:
        raise RuntimeError(
            "img2dataset is not installed; run the download stage on a "
            "machine with network access, then use --stage convert here."
        ) from e
    i2d_download(
        processes_count=processes,
        thread_count=threads,
        url_list=tsv_url_list,
        image_size=image_size,
        output_folder=output_dir,
        output_format="webdataset",
        input_format="tsv",
        url_col="url",
        caption_col="caption",
        enable_wandb=False,
        number_sample_per_shard=10000,
        distributor="multiprocessing",
    )


def convert_parquets(output_dir: str):
    """For each ``NNNNN.parquet`` beside its ``NNNNN.tar``, a ``NNNNN.tsv``
    of the successful rows as (tar, ``<key>.jpg``, caption), tabs and
    newlines in the caption as spaces. Returns the TSVs' paths."""
    import pandas as pd

    shard_tsvs = []
    for parquet in sorted(glob.glob(os.path.join(output_dir, "*.parquet"))):
        base = os.path.splitext(parquet)[0]
        tar = base + ".tar"
        if not os.path.exists(tar):
            continue
        df = pd.read_parquet(parquet)
        ok = df[df["status"] == "success"] if "status" in df else df
        out = base + ".tsv"
        with open(out, "w") as f:
            f.write("tar\tfile\tcaption\n")
            for _, row in ok.iterrows():
                caption = str(row.get("caption", "")).replace("\t", " ")
                caption = caption.replace("\n", " ")
                f.write(f"{tar}\t{row['key']}.jpg\t{caption}\n")
        shard_tsvs.append(out)
    logging.info(f"converted {len(shard_tsvs)} shards")
    return shard_tsvs


def split_index(output_dir: str, validation_shards: int = 1):
    """``validation.tsv`` lists the first ``validation_shards`` shard TSVs,
    ``training.tsv`` the rest (each under a ``filename`` header)."""
    shard_tsvs = sorted(glob.glob(os.path.join(output_dir, "*.tsv")))
    shard_tsvs = [t for t in shard_tsvs
                  if not t.endswith("training.tsv") and not t.endswith("validation.tsv")]
    val = shard_tsvs[:validation_shards]
    train = shard_tsvs[validation_shards:]
    for name, lst in (("training.tsv", train), ("validation.tsv", val)):
        with open(os.path.join(output_dir, name), "w") as f:
            f.write("filename\n")
            for t in lst:
                f.write(t + "\n")
    logging.info(f"index split: {len(train)} train / {len(val)} validation shards")


def main(argv=None):
    p = argparse.ArgumentParser(description="cc12m scraper")
    p.add_argument("--url-list", type=str, default="cc12m.tsv",
                   help="TSV with url/caption columns")
    p.add_argument("--output-dir", type=str, default="cc12m")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--stage", type=str, default="all",
                   choices=["all", "download", "convert", "split"])
    p.add_argument("--validation-shards", type=int, default=1)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.stage in ("all", "download"):
        download(args.url_list, args.output_dir, args.image_size)
    if args.stage in ("all", "convert"):
        convert_parquets(args.output_dir)
    if args.stage in ("all", "split"):
        split_index(args.output_dir, args.validation_shards)


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
