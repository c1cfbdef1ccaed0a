"""A tiny CLIP checkpoint directory for the CPU tests, written by
``transformers`` itself: a random ``CLIPModel`` (2 layers a tower, widths
32-64, patch 8 at 32 px) saved with ``save_pretrained``, a hand-written
byte-level BPE vocabulary (``vocab.json``: the 256 byte characters, their
``</w>`` forms, the merges' products and the two specials; ``merges.txt``
under its header line) and the image processor's config. Both the JAX
package's ``ClipFeatures`` (through ``transformers``) and the port's read it.
"""
import json
import os

WORDS = ["a", "the", "photo", "of", "cat", "dog", "red", "fox", "in", "snow", "at", "dawn",
         "blue", "sky", "over", "hills", "it's", "café", "2024", "painting"]


def _byte_chars():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def bpe_files():
    """(vocab dict, merges list): each word's merges left to right, so every
    merge's product is made before a later merge uses it."""
    enc = _byte_chars()
    chars = [enc[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for word in WORDS:
        for piece in word.replace("'", " '").split():
            sym = [enc[b] for b in piece.encode("utf-8")]
            sym[-1] += "</w>"
            cur = sym[0]
            for nxt in sym[1:]:
                if (cur, nxt) not in merges:
                    merges.append((cur, nxt))
                    vocab.setdefault(cur + nxt, len(vocab))
                cur = cur + nxt
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_tiny_clip(path, eos_rule="first", max_length=16, seed=0, safe=True):
    """A tiny CLIP directory at ``path``. ``eos_rule`` "first" writes the
    end token's id as ``eos_token_id`` (pool at its first occurrence);
    "argmax" writes 2, the older configs' value (pool at the largest id).
    ``max_length`` None leaves ``model_max_length`` out of
    ``tokenizer_config.json``. ``safe`` picks ``model.safetensors`` over
    ``pytorch_model.bin``."""
    import torch
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel

    os.makedirs(path, exist_ok=True)
    vocab, merges = bpe_files()
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    tok_cfg = {"tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>",
               "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
               "pad_token": "<|endoftext|>"}
    if max_length is not None:
        tok_cfg["model_max_length"] = max_length
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(tok_cfg, f)
    eos = vocab["<|endoftext|>"]
    cfg = CLIPConfig(
        # 8 ids above the end token's, which no caption gives (the pooling
        # tests need a row whose largest id is not the end token)
        text_config=dict(vocab_size=len(vocab) + 8, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=77,
                         bos_token_id=vocab["<|startoftext|>"], pad_token_id=eos,
                         eos_token_id=2 if eos_rule == "argmax" else eos),
        vision_config=dict(hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=8),
        projection_dim=24)
    torch.manual_seed(seed)
    model = CLIPModel(cfg).eval()
    with torch.no_grad():  # non-trivial norms, biases and class token
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias") or "class_embedding" in name:
                p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(path, safe_serialization=safe)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(path)
    return model
