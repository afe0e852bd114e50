"""Batched LM serving: fixed-slot batched decode with wave scheduling (the
reference's `repro.serve.engine`).

Requests are served in waves of `batch_slots`: each wave shares one batched
KV/state cache, prompts (left-padded with token 0, which is fed as a token)
prefill through `LM.prefill` (teacher-forced through `decode_step` for the
ten reference architectures, so the cache semantics are those of decode;
one batched forward for the MLA block), then all slots decode together one
token per step until EOS or `max_new_tokens`.  Sampling at temperature > 0 is
`prng.categorical` keyed by the stable coordinates
`fold_in(fold_in(root, wave), step)`, its uniform drawn by the threefry
kernel on the card; temperature 0 is greedy.  The engine waits for the card
where the reference blocks: at the end of each prefill lap, and when the
sampled tokens come to the host.

On a CUDA device the MLA block's decode step runs as CUDA graphs
(`DecodeGraphs`): captured at the engine's first wave, one for each
`GRAPH_BUCKET` of cache positions read, over a cache, a token buffer and
a position that stay put; a step is then one launch where the eager step
launches some hundred kernels a layer from the host.  The graphs' results
are those of the eager step, but for the order of the attention's sums
over the masked positions.

While a profiler trace runs (`obs.spans`), each wave is an `lm_wave` span
(wave, slots, live requests, prompt tokens, padded tokens) holding an
`lm_prefill` span (wave, tokens, `device_ms`) and an `lm_decode` span
(wave, steps, `device_ms`); for the MLA block the wave also tallies the
(token, expert) pairs of each MoE layer on the card and reads the busiest
expert's and the mean expert's share (`expert_busiest`, `expert_mean`,
summed over layers) with the wave's last sampled tokens.  Inside the
captured decode step no span opens: its layers' attention is not under
`mla_attend`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.mla import DecodeAt
from repro_torch.models.transformer import LM
from repro_torch.obs import PhaseTimer, RunLog, as_runlog, spans

PyTree = Any


#: the step of the captured decode steps' cache reads: a step at position
#: p replays the graph that reads the least multiple of it above p (or
#: all `max_len` positions)
GRAPH_BUCKET = 512


class DecodeGraphs:
    """The MLA block's decode step (`LM.decode_at`) captured as CUDA
    graphs, one for each `GRAPH_BUCKET` of cache positions read up to
    `max_len`, sharing one memory pool, over inputs that stay put: the
    wave's cache (`cache`, zeroed by `reset`), the tokens fed and the
    position written.  Each graph also stacks the experts each MoE layer
    chose ([MoE layers, slots, k] int16, for `LM.route_log`) and adds the
    pairs each expert took to `tally` ([MoE layers, experts])."""

    def __init__(self, lm: LM, params: PyTree, slots: int, max_len: int,
                 device: torch.device):
        cfg = lm.cfg
        self.lm = lm
        self.cache = lm.init_cache(slots, max_len, device=device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                  device=device)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
        self.tally = torch.zeros((cfg.n_layers - cfg.n_dense_prefix,
                                  cfg.n_experts), dtype=torch.int64,
                                 device=device)
        self.graphs: Dict[int, Any] = {}
        lengths = list(range(GRAPH_BUCKET, max_len, GRAPH_BUCKET)) + [max_len]
        saved = lm.route_log, lm.expert_tally
        try:
            # one eager step on a side stream first, as capture asks, so
            # the libraries' lazy set-up stays out of the graphs
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._step(params, lengths[0])
            torch.cuda.current_stream(device).wait_stream(side)
            pool = None
            for n in lengths:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool):
                    out = self._step(params, n)
                pool = g.pool()
                self.graphs[n] = (g, *out)
        finally:
            lm.route_log, lm.expert_tally = saved
        self.reset()

    def _step(self, params: PyTree, length: int):
        """(logits, experts chosen) of one step reading `length`
        positions."""
        self.lm.route_log, self.lm.expert_tally = [], self.tally
        logits = self.lm.decode_at(params, self.tokens, self.cache,
                                   DecodeAt.within(self.pos, length))
        return logits, torch.stack(self.lm.route_log)

    def reset(self) -> PyTree:
        """The cache (its index 0) and `tally` zeroed for a new wave."""
        for name, c in self.cache.items():
            if name != "index":
                c["latent"].zero_()
        self.tally.zero_()
        return self.cache

    def step(self, tokens: np.ndarray, index: int) -> torch.Tensor:
        """Feed `tokens` [slots] at position `index` -> the step's logits
        [slots, 1, V] (the graph's own buffer, rewritten by the next
        step); the chosen experts go to `LM.route_log` where it is set."""
        self.tokens.copy_(torch.from_numpy(tokens[:, None].astype(np.int64)))
        self.pos.fill_(index)
        n = min(-(-(index + 1) // GRAPH_BUCKET) * GRAPH_BUCKET,
                max(self.graphs))
        g, logits, routes = self.graphs[n]
        g.replay()
        if self.lm.route_log is not None:
            self.lm.route_log.extend(routes.clone().unbind(0))
        return logits


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
    engine runs on the device of `params["embed"]`.  `logits_hook(wave,
    step, logits)`, where given, sees each step's logits [slots, 1, V] on
    the card: step 0 the prefill's last position, step s the decode step
    that fed the s-th sampled token."""

    def __init__(self, lm: LM, params: PyTree, *, batch_slots: int = 4,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 obs: Optional[RunLog] = None,
                 logits_hook: Optional[Callable] = None):
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
        self.logits_hook = logits_hook
        # device values that ride along with the next sampled tokens'
        # copy to the host, and what they read there
        self._ride: Optional[torch.Tensor] = None
        self._ridden: Optional[np.ndarray] = None
        self._use_graphs = (lm.cfg.block == "mla"
                             and self.device.type == "cuda")
        self._graphs: Optional[DecodeGraphs] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, *, wave: int,
                step: int) -> np.ndarray:
        last = logits[:, -1, :]
        if self.temperature > 0:
            k = prng.fold_in(prng.fold_in(self._root_key, wave), step)
            toks = prng.categorical(k, last / self._temperature)
        else:
            toks = torch.argmax(last, dim=-1)
        if self._ride is None:
            return toks.cpu().numpy().astype(np.int32)
        both = torch.cat([toks.long(), self._ride.long()]).cpu().numpy()
        self._ride, self._ridden = None, both[toks.shape[0]:]
        return both[:toks.shape[0]].astype(np.int32)

    def _tally(self) -> Optional[torch.Tensor]:
        """A zero [MoE layers, experts] tally for the wave, set on the LM,
        while a trace runs and the block is MLA; None otherwise."""
        cfg = self.lm.cfg
        if not spans.spans_on() or cfg.block != "mla":
            self.lm.expert_tally = None
            return None
        if self._graphs is not None:      # zeroed with the wave's cache
            self.lm.expert_tally = self._graphs.tally
            return self._graphs.tally
        self.lm.expert_tally = torch.zeros(
            (cfg.n_layers - cfg.n_dense_prefix, cfg.n_experts),
            dtype=torch.int64, device=self.device)
        return self.lm.expert_tally

    def _tally_summary(self, tally: torch.Tensor) -> torch.Tensor:
        """[the busiest expert's pairs summed over MoE layers, all pairs]
        on the card."""
        return torch.stack([tally.max(dim=1).values.sum(), tally.sum()])

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
            if self._use_graphs:
                if self._graphs is None:
                    self._graphs = DecodeGraphs(self.lm, self.params,
                                                self.slots, self.max_len, dev)
                cache = self._graphs.reset()
            else:
                cache = self.lm.init_cache(self.slots, self.max_len,
                                           device=dev)
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
            wave_no = self._waves
            tally = self._tally()
            with spans.span("lm_wave", wave=wave_no, slots=self.slots,
                            requests=len(wave), prompt_tokens=prompt_toks,
                            padded_tokens=self.slots * maxlen) as wspan:
                with self.prefill_timer.lap(items=prompt_toks):
                    with spans.device_span("lm_prefill", dev, wave=wave_no,
                                           tokens=self.slots * maxlen):
                        logits, cache = self.lm.prefill(self.params,
                                                        toks_dev, cache)
                    self._sync()
                if self.logits_hook is not None:
                    self.logits_hook(wave_no, 0, logits)
                out_tokens: List[List[int]] = [[] for _ in wave]
                finished = [False] * len(wave)
                with self.decode_timer.lap() as lap, \
                        spans.span("lm_decode", wave=wave_no) as dspan:
                    cur = self._sample(logits, wave=wave_no, step=0)
                    start, end, steps = spans.device_mark(dev), None, 0
                    for step in range(max_new_tokens):
                        for s in range(len(wave)):
                            if not finished[s]:
                                out_tokens[s].append(int(cur[s]))
                                if (self.eos_id is not None
                                        and cur[s] == self.eos_id):
                                    finished[s] = True
                        if all(finished):
                            break
                        if self._graphs is not None:
                            logits = self._graphs.step(cur, maxlen + step)
                        else:
                            logits, cache = step_fn(
                                self.params,
                                torch.from_numpy(cur[:, None]).to(dev), cache)
                        steps += 1
                        if self.logits_hook is not None:
                            self.logits_hook(wave_no, step + 1, logits)
                        if step + 1 == max_new_tokens:
                            end = spans.device_mark(dev)
                            if tally is not None:
                                self._ride = self._tally_summary(tally)
                        cur = self._sample(logits, wave=wave_no,
                                           step=step + 1)
                    lap.items = sum(len(t) for t in out_tokens)
                    dspan.set(steps=steps,
                              **({} if end is None else
                                 {"device_ms": spans.elapsed_ms(start, end)}))
                if tally is not None:
                    read = self._ridden
                    if read is None:         # ended at EOS: read it apart
                        read = self._tally_summary(tally).cpu().numpy()
                    wspan.set(expert_busiest=int(read[0]),
                              expert_mean=float(read[1])
                              / self.lm.cfg.n_experts)
                    self._ridden = self.lm.expert_tally = None
                spans.settle_device_ms()
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
