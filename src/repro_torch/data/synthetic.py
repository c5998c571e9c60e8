"""Deterministic synthetic datasets (reference: ``repro/data/synthetic.py``,
a numpy-only copy).

Classification: each class draws tokens from its own multinomial over the
vocabulary (class-conditional unigram clusters + shared background), so a
small transformer learns it well above chance and a Dirichlet label skew
gives non-IID clients.  Seq2seq: a tagged transformation task (copy /
reverse / shift selected by a control token).  LM: a sparse first-order
Markov stream.  The same seeds give the reference's arrays bit for bit:
every draw is the reference's, in its order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    tokens: np.ndarray               # (N, L) int32
    labels: np.ndarray               # (N,) int32 (classification)

    def __len__(self):
        return len(self.tokens)


def make_classification(n_samples: int, n_classes: int, vocab: int,
                        seq_len: int, seed: int = 0, task_seed: int = 1234,
                        ) -> Dataset:
    """``task_seed`` fixes the class-conditional distributions (the *task*);
    ``seed`` draws the samples — train/test share task_seed, not seed."""
    task_rng = np.random.default_rng(task_seed)
    background = task_rng.dirichlet(np.full(vocab, 0.5))
    cls_probs = np.empty((n_classes, vocab))
    for c in range(n_classes):
        focus = task_rng.dirichlet(np.full(vocab, 0.05))
        cls_probs[c] = 0.4 * background + 0.6 * focus
        cls_probs[c] /= cls_probs[c].sum()
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_samples).astype(np.int32)
    tokens = np.empty((n_samples, seq_len), np.int32)
    for c in range(n_classes):
        idx = np.nonzero(labels == c)[0]
        if idx.size:
            tokens[idx] = rng.choice(vocab, size=(idx.size, seq_len),
                                     p=cls_probs[c]).astype(np.int32)
    return Dataset(tokens, labels)


def make_seq2seq(n_samples: int, vocab: int, src_len: int, tgt_len: int,
                 seed: int = 0) -> dict:
    """Control-token task: 0=copy prefix, 1=reverse prefix, 2=shift(+1)."""
    rng = np.random.default_rng(seed)
    ctrl = rng.integers(0, 3, n_samples)
    body = rng.integers(3, vocab, (n_samples, src_len - 1)).astype(np.int32)
    src = np.concatenate([ctrl[:, None].astype(np.int32), body], axis=1)
    prefix = body[:, :tgt_len]
    tgt = np.where(ctrl[:, None] == 0, prefix,
                   np.where(ctrl[:, None] == 1, prefix[:, ::-1],
                            (prefix + 1) % vocab)).astype(np.int32)
    return {"src": src, "tgt": tgt}


def make_lm_stream(n_samples: int, vocab: int, seq_len: int,
                   seed: int = 0, order: int = 1) -> dict:
    """First-order Markov chain with sparse transitions (learnable).  One
    ``rng.choice`` per sample and position, as the reference draws them
    (a vectorized draw would give other tokens)."""
    rng = np.random.default_rng(seed)
    k = 4                                     # successors per token
    succ = rng.integers(0, vocab, (vocab, k)).astype(np.int32)
    probs = rng.dirichlet(np.full(k, 0.6), size=vocab)
    toks = np.empty((n_samples, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_samples)
    for t in range(seq_len):
        choice = np.array([rng.choice(k, p=probs[c]) for c in toks[:, t]])
        toks[:, t + 1] = succ[toks[:, t], choice]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def batches(data: Dataset, batch_size: int, rng: np.random.Generator,
            epochs: int = 1, drop_remainder: bool = True):
    n = len(data)
    for _ in range(epochs):
        order = rng.permutation(n)
        stop = n - n % batch_size if drop_remainder else n
        for i in range(0, max(stop, batch_size) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield {"tokens": data.tokens[idx], "labels": data.labels[idx]}
