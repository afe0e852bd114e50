"""Deterministic synthetic LM token pipeline (the reference's
`repro.data.lm`, numpy draw for numpy draw).

Stateless-seeded: batch(step) is a pure function of (seed, step), so a
restarted job resumes exactly where it left off with no data-loader state
in the checkpoint.  Each host materializes only its own shard, and the
stream has learnable n-gram structure.  Batches are int32 tensors on
`device`, equal to the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.runtime import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_clusters: int = 64       # markov structure: vocab clusters

    def batch_for_step(self, step: int, host_id: int = 0, n_hosts: int = 1,
                       device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
        return lm_batch_for_step(self.vocab_size, self.seq_len,
                                 self.global_batch, step, self.seed,
                                 self.n_clusters, host_id, n_hosts, device)


def lm_batch_for_step(vocab_size: int, seq_len: int, global_batch: int,
                      step: int, seed: int = 0, n_clusters: int = 64,
                      host_id: int = 0, n_hosts: int = 1,
                      device: DeviceLike = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Markov-chain tokens: next token's cluster depends on the previous
    token's cluster (learnable structure), token within cluster uniform."""
    dev = resolve_device(device)
    local_batch = global_batch // n_hosts
    rng = np.random.default_rng((seed, step, host_id))
    n_clusters = min(n_clusters, vocab_size)
    per = max(vocab_size // n_clusters, 1)
    # deterministic cluster-transition table from the seed
    trng = np.random.default_rng(seed)
    trans = trng.permutation(n_clusters)

    clusters = np.empty((local_batch, seq_len + 1), np.int64)
    clusters[:, 0] = rng.integers(0, n_clusters, local_batch)
    noise = rng.random((local_batch, seq_len)) < 0.1
    for t in range(seq_len):
        nxt = trans[clusters[:, t]]
        rand = rng.integers(0, n_clusters, local_batch)
        clusters[:, t + 1] = np.where(noise[:, t], rand, nxt)
    within = rng.integers(0, per, (local_batch, seq_len + 1))
    toks = np.minimum(clusters * per + within, vocab_size - 1)
    as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return {"tokens": as_t(toks[:, :-1]), "labels": as_t(toks[:, 1:])}
