"""Prompt tokenization and encoding, and new-token embedding rows.

Twin of ``instantir_tpu/utils/text.py`` (the reference's dormant
``utils/text_utils.py``): ``tokenize_prompt`` / ``encode_prompt`` (the SDXL
multi-tower embedding) and ``add_tokens`` / ``patch_token_embeddings``
(placeholder tokens). The JAX functions return new parameter trees; here the
text encoder's embedding table is changed in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def tokenize_prompt(tokenizer, prompt: Sequence[str], max_length: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Batch-tokenize with max-length padding and truncation -> int64 ``[B, max_length]``."""
    ids = tokenizer(list(prompt), padding="max_length", max_length=max_length or tokenizer.model_max_length,
                    truncation=True)["input_ids"]
    return torch.tensor(ids, dtype=torch.long, device=device)


@torch.no_grad()
def encode_prompt(encoders, ids_list) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-tower prompt embedding: each tower's penultimate hidden state,
    concatenated on channels; the pooled projection of the last tower that
    has one (``CLIPTextModel`` returns (last, penultimate, pooled))."""
    embeds, pooled = [], None
    for enc, ids in zip(encoders, ids_list):
        _, h, p = enc(ids)
        embeds.append(h)
        if p is not None:
            pooled = p
    if pooled is None:
        raise ValueError("the final text encoder must have a projection head (pooled output)")
    return torch.cat(embeds, dim=-1), pooled


@torch.no_grad()
def add_tokens(encoder, num_new: int, pad_to_multiple_of: int = 128,
               generator: Optional[torch.Generator] = None) -> int:
    """Append rows for ``num_new`` placeholder tokens to ``encoder``'s token
    embedding (N(0, 0.01²), the table padded to a multiple of
    ``pad_to_multiple_of``) and widen its config's ``vocab_size``. Returns the
    id of the first new token."""
    old = encoder.text_model.embeddings.token_embedding
    vocab, dim = old.weight.shape
    padded = -(-(vocab + num_new) // pad_to_multiple_of) * pad_to_multiple_of
    extra = torch.randn((padded - vocab, dim), generator=generator, dtype=torch.float32,
                        device=old.weight.device) * 0.01
    table = nn.Embedding(padded, dim, dtype=old.weight.dtype, device=old.weight.device)
    table.weight.copy_(torch.cat([old.weight, extra.to(old.weight.dtype)]))
    encoder.text_model.embeddings.token_embedding = table
    encoder.config = dataclasses.replace(encoder.config, vocab_size=padded)
    return vocab


@torch.no_grad()
def patch_token_embeddings(encoder, token_ids: Sequence[int], embeddings: torch.Tensor) -> None:
    """Write learned embeddings into the rows of ``token_ids`` (the reference's
    ``patch_embedding_forward`` substitutes them at forward time; writing the
    rows once is the same for a frozen table)."""
    table = encoder.text_model.embeddings.token_embedding.weight
    ids = torch.as_tensor(list(token_ids), dtype=torch.long, device=table.device)
    table[ids] = torch.as_tensor(embeddings).to(table).reshape(len(token_ids), table.shape[-1])
