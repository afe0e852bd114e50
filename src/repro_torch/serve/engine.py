"""Batched LM serving: fixed-slot batched decode with wave scheduling (the
reference's `repro.serve.engine`).

Requests are served in waves of `batch_slots`: each wave shares one batched
KV/state cache, prompts (left-padded with token 0, which is fed as a token)
prefill teacher-forced through `decode_step`, so the cache semantics are
those of decode, then all slots decode together one token per step until
EOS or `max_new_tokens`.  Sampling at temperature > 0 is
`prng.categorical` keyed by the stable coordinates
`fold_in(fold_in(root, wave), step)`, its uniform drawn by the threefry
kernel on the card; temperature 0 is greedy.  The engine waits for the card
where the reference blocks: at the end of each prefill lap, and when the
sampled tokens come to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.transformer import LM
from repro_torch.obs import PhaseTimer, RunLog, as_runlog

PyTree = Any


@dataclasses.dataclass
class GenerationResult:
    """One completed LM request: the prompt echoed back, the generated
    token ids, and whether EOS was reached before the token budget."""
    prompt: List[int]
    tokens: List[int]
    finished: bool


class ServeEngine:
    """`obs` (a `repro_torch.obs.RunLog`) streams per-wave telemetry:
    prefill vs decode wall time, new tokens, tokens/sec; the phase timers
    split the first wave from steady-state throughput (`stats()`).  The
    engine runs on the device of `params["embed"]`."""

    def __init__(self, lm: LM, params: PyTree, *, batch_slots: int = 4,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 obs: Optional[RunLog] = None):
        self.lm = lm
        self.params = params
        self.device = params["embed"].device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        # root key only: sampling keys derive from stable coordinates
        # (wave index, decode step), never from a split chain in engine
        # state, so a request's draws do not depend on earlier requests
        self._root_key = prng.PRNGKey(seed, device=self.device)
        self._temperature = torch.tensor(np.float32(temperature),
                                         device=self.device)
        self.obs = as_runlog(obs)
        self.prefill_timer = PhaseTimer("serve_prefill", unit="tokens")
        self.decode_timer = PhaseTimer("serve_decode", unit="tokens")
        self._waves = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, *, wave: int,
                step: int) -> np.ndarray:
        last = logits[:, -1, :]
        if self.temperature > 0:
            k = prng.fold_in(prng.fold_in(self._root_key, wave), step)
            return prng.categorical(k, last / self._temperature).cpu(
            ).numpy().astype(np.int32)
        return torch.argmax(last, dim=-1).cpu().numpy().astype(np.int32)

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32
                 ) -> List[GenerationResult]:
        """Serve `prompts` in waves of `self.slots`: batched prefill, then
        step-wise decode until EOS or `max_new_tokens`.  Results come back
        in prompt order regardless of wave composition."""
        results: List[Optional[GenerationResult]] = [None] * len(prompts)
        queue = list(enumerate(prompts))
        step_fn = self.lm.decode_step
        dev = self.device
        while queue:
            wave = queue[:self.slots]
            queue = queue[self.slots:]
            cache = self.lm.init_cache(self.slots, self.max_len, device=dev)
            maxlen = max(len(p) for _, p in wave)
            if maxlen + max_new_tokens > self.max_len:
                raise ValueError(f"cache too small: prompt {maxlen} + "
                                 f"{max_new_tokens} new > max_len "
                                 f"{self.max_len}")
            toks = np.zeros((self.slots, maxlen), np.int32)
            for s, (_, p) in enumerate(wave):
                toks[s, maxlen - len(p):] = p      # left-pad to align ends
            toks_dev = torch.from_numpy(toks).to(dev)
            logits = None
            prompt_toks = sum(len(p) for _, p in wave)
            with self.prefill_timer.lap(items=prompt_toks):
                for t in range(maxlen):           # teacher-forced prefill
                    logits, cache = step_fn(self.params,
                                            toks_dev[:, t:t + 1], cache)
                self._sync()
            out_tokens: List[List[int]] = [[] for _ in wave]
            finished = [False] * len(wave)
            with self.decode_timer.lap() as lap:
                cur = self._sample(logits, wave=self._waves, step=0)
                for step in range(max_new_tokens):
                    for s in range(len(wave)):
                        if not finished[s]:
                            out_tokens[s].append(int(cur[s]))
                            if (self.eos_id is not None
                                    and cur[s] == self.eos_id):
                                finished[s] = True
                    if all(finished):
                        break
                    logits, cache = step_fn(
                        self.params,
                        torch.from_numpy(cur[:, None]).to(dev), cache)
                    cur = self._sample(logits, wave=self._waves,
                                       step=step + 1)
                lap.items = sum(len(t) for t in out_tokens)
            self._waves += 1
            self.obs.log_event(
                "serve_wave", wave=self._waves, requests=len(wave),
                prompt_tokens=prompt_toks,
                new_tokens=int(lap.items),
                prefill_s=self.prefill_timer.last_s,
                decode_s=self.decode_timer.last_s,
                tokens_per_sec=lap.items / max(self.decode_timer.last_s,
                                               1e-9))
            for s, (req, p) in enumerate(wave):
                results[req] = GenerationResult(prompt=list(p),
                                                tokens=out_tokens[s],
                                                finished=finished[s])
        return [r for r in results if r is not None]

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Phase summaries: the first wave split from steady-state
        prefill/decode tokens/sec."""
        return {"prefill": self.prefill_timer.summary(),
                "decode": self.decode_timer.summary()}

    def log_stats(self) -> None:
        """Emit the prefill/decode phase summaries to the run log."""
        self.prefill_timer.log_to(self.obs, waves=self._waves)
        self.decode_timer.log_to(self.obs, waves=self._waves)
