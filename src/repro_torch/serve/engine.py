"""Batched LM serving engine: prefill, then lock-step decode over fixed
slots. Counterpart of ``repro/serve/engine.py:ServeEngine``.

The reference jit-compiles a (prefill, step) pair per signature; the port
runs eagerly, one kernel launch per attention, Mamba or RWKV6 layer and
step (flash attention, the selective scan, wkv6). The cache
length is a host int, so the decode loop reads nothing back from the
card until the tokens are returned: the host runs ahead and queues the
steps.
"""

from __future__ import annotations

import torch

from ..models import transformer
from ..models.config import ModelCfg


class ServeEngine:
    def __init__(self, cfg: ModelCfg, model: transformer.DecoderLM,
                 max_len: int):
        if model.cfg != cfg:
            raise ValueError(f"ServeEngine: the model is {model.cfg.name}'s "
                             f"config, not the one given ({cfg.name})")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, prompts, n_new: int, greedy: bool = True,
                 generator: torch.Generator | None = None):
        """prompts: (B, P) int tokens on the model's device. Returns
        (B, n_new) int32 generated tokens. ``greedy=False`` samples from
        the softmax with ``torch.multinomial`` on ``generator`` (its
        numbers differ from ``jax.random.categorical``'s)."""
        P = prompts.shape[1]
        ring = self.cfg.window is not None and self.cfg.window < self.max_len
        if not ring and P + n_new - 1 > self.max_len:
            raise ValueError(f"ServeEngine: {P} prompt + {n_new} new tokens "
                             f"need {P + n_new - 1} cache slots, max_len is "
                             f"{self.max_len}")
        logits, cache = transformer.prefill(self.model, prompts,
                                            self.max_len)
        out = []
        for i in range(n_new):
            last = logits[:, -1]
            if greedy:
                tok = torch.argmax(last, dim=-1, keepdim=True)
            else:
                tok = torch.multinomial(torch.softmax(last.float(), dim=-1),
                                        1, generator=generator)
            out.append(tok)
            if i + 1 < n_new:
                logits, cache = transformer.decode_step(self.model, cache,
                                                        tok)
        return torch.cat(out, dim=1).to(torch.int32)
