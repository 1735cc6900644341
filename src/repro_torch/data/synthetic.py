"""Deterministic synthetic data pipeline.

A seeded first-order Markov chain over the vocabulary (Zipfian marginals,
banded transitions) — cheap to generate, deterministic, and *learnable*:
cross-entropy drops well below the unigram entropy, so convergence
experiments (paper Fig. 3/4 analogues) have a real signal.

Sharding contract: ``batches(...)`` yields host-local shards, keyed by
(seed, step, host) — every host computes only its rows, any host can
deterministically regenerate any step (checkpoint resume = set cursor;
elastic rescale = change n_hosts, data order stays a pure function of
the step index).  For the audio (whisper) family the "frontend stub"
emits pseudo frame embeddings derived from the same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 32        # out-degree of the Markov chain


class MarkovLM:
    """Vocab-sized first-order chain with Zipf marginals."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # each token transitions to `branching` successors with Zipf weights
        self.successors = rng.randint(0, v, size=(v, cfg.branching))
        w = 1.0 / np.arange(1, cfg.branching + 1) ** 1.2
        self.weights = (w / w.sum()).astype(np.float64)

    def sample_rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Generate tokens (len(rows), seq_len) for global row ids at a
        step — pure function of (seed, step, row)."""
        cfg = self.cfg
        out = np.empty((len(rows), cfg.seq_len + 1), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step * 7_919 + int(r)) % 2**31)
            tok = rng.randint(cfg.vocab_size)
            choices = rng.choice(cfg.branching, size=cfg.seq_len + 1,
                                 p=self.weights)
            for t in range(cfg.seq_len + 1):
                out[i, t] = tok
                tok = self.successors[tok, choices[t]]
        return out

    def unigram_entropy_bound(self) -> float:
        """Entropy of the transition distribution = achievable loss floor."""
        w = self.weights
        return float(-(w * np.log(w)).sum())


def batches(model_cfg: ModelConfig, data_cfg: DataConfig, *,
            host_index: int = 0, n_hosts: int = 1,
            start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Host-sharded batch iterator.  Rows [host_index::n_hosts]."""
    if data_cfg.global_batch % n_hosts:
        raise ValueError("global_batch must divide across hosts")
    chain = MarkovLM(data_cfg)
    rows = np.arange(data_cfg.global_batch)[host_index::n_hosts]
    step = start_step
    while True:
        toks = chain.sample_rows(step, rows)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if model_cfg.family == "audio":
            # frontend stub: pseudo frame embeddings from the token ids
            rng = np.random.RandomState(data_cfg.seed + 17)
            proj = rng.randn(64, model_cfg.d_model).astype(np.float32) * 0.1
            batch["frames"] = proj[toks[:, :-1] % 64]
        yield batch
        step += 1


def loss_floor(data_cfg: DataConfig) -> float:
    """Achievable NLL on this stream (the chain's conditional entropy)."""
    return MarkovLM(data_cfg).unigram_entropy_bound()
