"""Language model factory: the tokenizer and the frozen text tower.

Counterpart of ``ml_mdm_tpu/language_models/factory.py``:
``create_lm(args, device)`` returns (tokenizer, language_model), and
``language_model(sample, tokenizer)`` returns (lm_outputs, lm_mask). Modes:

- precomputed text embeddings (``use_precomputed_text_embeddings``): no
  encoder, ``sample["text_embedding"]`` is the output;
- categorical conditioning: the one-hot of each caption's second token;
- ``text_model`` ``random:<d>``: a tiny encoder of width d with seeded
  random weights (the hermetic tests);
- otherwise ``text_model`` is a local Hugging Face T5 checkpoint directory
  (``t5.load_t5_from_torch``).

As in the JAX package, the mask is ``tokens != pad`` and the outputs are
multiplied by it. The encoder runs in the profiler range "text tower".
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ml_mdm_tpu_torch.language_models.t5 import T5Config, T5Encoder, init_t5_, load_t5_from_torch
from ml_mdm_tpu_torch.language_models.tokenizer import Tokenizer


class LanguageModel:
    """The frozen text tower on ``device``: (sample, tokenizer) ->
    (lm_outputs (B, L, d) f32, lm_mask (B, L) f32 or None)."""

    def __init__(self, args, encoder: Optional[T5Encoder], device):
        self.args = args
        self.device = torch.device(device)
        self.precomputed = bool(getattr(args, "use_precomputed_text_embeddings", 0))
        self.encoder = None if self.precomputed else encoder
        self.embed_dim = encoder.embed_dim if encoder is not None else -1

    @torch.no_grad()
    def __call__(self, sample, tokenizer) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        tokens = torch.as_tensor(np.asarray(sample["tokens"]), dtype=torch.long,
                                 device=self.device)
        if getattr(self.args, "categorical_conditioning", 0):
            return F.one_hot(tokens[:, 1], tokenizer.vocab_size).float()[:, None, :], None
        pad = tokenizer.token_id(self.args.reader_config.padding_token)
        lm_mask = (tokens != pad).float()
        if self.precomputed:
            lm_outputs = torch.as_tensor(np.asarray(sample["text_embedding"]),
                                         dtype=torch.float32, device=self.device)
        else:
            with record_function("text tower"):
                lm_outputs = self.encoder(tokens, lm_mask).float()
        return lm_outputs * lm_mask[..., None], lm_mask


def create_tokenizer(vocab_file: str) -> Tokenizer:
    return Tokenizer(vocab_file, mode="t5")


def create_lm(args, device, seed: int = 0):
    """(tokenizer, language model) for ``args`` on ``device``; ``seed``
    makes the weights of a ``random:<d>`` encoder."""
    tokenizer = create_tokenizer(args.vocab_file)
    if getattr(args, "categorical_conditioning", 0):
        model = LanguageModel(args, None, device)
        model.embed_dim = tokenizer.vocab_size
        return tokenizer, model
    if getattr(args, "use_precomputed_text_embeddings", 0):
        return tokenizer, LanguageModel(args, None, device)
    text_model = str(getattr(args, "text_model", "google/flan-t5-xl"))
    if text_model.startswith("random:"):
        d = int(text_model.split(":")[1])
        cfg = T5Config(vocab_size=tokenizer.vocab_size + 16, d_model=d, d_kv=max(d // 4, 8),
                       d_ff=2 * d, num_layers=2, num_heads=4)
        enc = T5Encoder(cfg).to(device)
        init_t5_(enc, torch.Generator(device=device).manual_seed(seed))
        return tokenizer, LanguageModel(args, enc.eval(), device)
    return tokenizer, LanguageModel(args, load_t5_from_torch(text_model, device), device)
