"""One process of tests/test_torch_distributed.py: a rank of a two-process
gloo run of the port's training CLI on the CPU.

    python tests/torch_mp_child.py <outdir>

The parent sets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), which ``init_distributed_singlenode`` reads.
The child records what the parent checks in ``record_<rank>.json``.
"""
import hashlib
import json
import logging
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from ml_mdm_tpu_torch import parallel, reader  # noqa: E402
from ml_mdm_tpu_torch.clis import train_parallel  # noqa: E402
from ml_mdm_tpu_torch.config import get_arguments  # noqa: E402
from ml_mdm_tpu_torch.utils import simple_logger  # noqa: E402

torch.set_num_threads(1)
logging.basicConfig(level=logging.INFO)


def main(outdir):
    rank = int(os.environ["RANK"])
    args = get_arguments([
        "--config_path", os.path.join(HERE, "test_files", "tiny_train.yaml"),
        "--file-list", os.path.join(HERE, "test_files", "sample_training_0.tsv"),
        "--vocab_file", os.path.join(HERE, "test_files", "tiny_t5.vocab"),
        "--output-dir", outdir, "--save-freq", "1", "--batch-size", "4",
        "--num-training-steps", "2", "--multinode", "1", "--device", "cpu",
        "--reader_config.num_readers", "1",
    ], mode="trainer")
    record = {"rank": rank}

    orig_partition = reader.get_dataset_partition

    def partition_spy(partition_num, num_partitions, *a, **kw):
        record["partition_num"], record["num_partitions"] = partition_num, num_partitions
        return orig_partition(partition_num, num_partitions, *a, **kw)

    reader.get_dataset_partition = partition_spy
    digests = []
    orig_load = train_parallel.load_batch

    def load_spy(sample, language_model, tokenizer):
        out = orig_load(sample, language_model, tokenizer)
        digests.append([reader.convert(c) for c in out["caption"]])
        return out

    train_parallel.load_batch = load_spy
    losses = []
    orig_scalar = simple_logger.Logger.add_scalar

    def scalar_spy(self, name, value):
        if name == "loss":
            losses.append(float(value))
        return orig_scalar(self, name, value)

    simple_logger.Logger.add_scalar = scalar_spy

    state = train_parallel.main(args)

    h = hashlib.sha256()
    for k, p in state.params.items():
        h.update(k.encode() + p.detach().numpy().tobytes())
    record.update(digests=digests, losses=losses, final_step=state.step,
                  params_sha256=h.hexdigest(),
                  params_l2=float(sum(float((p.detach() ** 2).sum()) for p in state.params.values())))

    # all_reduce_mean over several buckets of two dtypes
    parallel.mesh.BUCKET_BYTES = 64
    ts = [torch.full((7,), float(rank + 1)), torch.arange(40.0) * (rank + 1),
          torch.full((3,), rank + 1.0, dtype=torch.bfloat16)]
    parallel.all_reduce_mean(ts)
    record["reduced"] = [t.float().tolist() for t in ts]
    with open(os.path.join(outdir, f"record_{rank}.json"), "w") as f:
        json.dump(record, f)
    print(f"torch_mp_child rank {rank} done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
