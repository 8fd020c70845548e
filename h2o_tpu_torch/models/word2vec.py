"""Word2Vec — skip-gram embeddings (``h2o_tpu/models/word2vec.py``).

The reference's redesign of `hex/word2vec/` kept: skip-gram with negative
sampling (H2O-3 trains hierarchical softmax), each step one batch of
(center, context, k negatives) dot products, scores clamped at ±6, each
word's summed update scaled by 1/√(its batch multiplicity), the learning
rate decayed linearly. The input is one string column (a host ``T_STR``
column, or a categorical one), sentences split by NA rows; ``transform``
(word → vector, AVERAGE pooling per sentence) and ``find_synonyms``
(cosine) mirror the public API, and ``pre_trained`` imports a [Word,
V1..VD] frame.

What the reference draws, the port draws alike: the vocabulary (counts in
first-seen order, sorted by count), the training pairs (built here with
numpy instead of a Python loop; the same array in the same order), numpy's
``default_rng(seed)`` calls in the reference's order (``integers`` for the
key, ``permutation`` per epoch, then the steps' ``choice(V, p=probs)``
draws, 256 steps' worth a call: the same uniforms in the same order, so
the negatives are equal) and W from ``threefry.uniform`` (bit-equal to
``jax.random.uniform``). A step waits for nothing on the host: the
epoch's order and a chunk's negatives are copied to the device once.

The three scatter-adds of a step are deterministic (``_scatter_add``): on
a CPU tensor ``index_add_`` applies the updates one after another in index
order, as XLA's CPU scatter does (``index_put_(accumulate=True)`` there
runs float atomics across threads past 32,768 elements); on a CUDA tensor
``index_put_(accumulate=True)`` sorts the indices (a stable sort) and sums
each index's updates in that order, unlike ``index_add_``'s float
atomics. So two runs give bit-equal vectors on either device. On the card
each step is one replay of a CUDA graph of the step (``_Stepper``).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import threefry
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class Word2VecParameters(Parameters):
    vec_size: int = 100
    window_size: int = 5
    min_word_freq: int = 5
    epochs: int = 5
    negative_samples: int = 5    # negative-sampling k (divergence from HS)
    init_learning_rate: float = 0.025
    sent_sample_rate: float = 1e-3
    pre_trained: object = None   # Frame [Word, V1..VD] — import external
                                 # embeddings instead of training
    device: Any = None           # where a frame of host columns trains
                                 # (default cuda; a frame with device
                                 # columns trains on their device)


#: steps whose negatives are drawn and copied to the device at once
_NEG_CHUNK = 256


def _words(v: Vec) -> np.ndarray:
    """A word column on the host: strings, None for NA."""
    if v.is_string():
        return v.host_data
    return np.array([None if np.isnan(c) else v.domain[int(c)]
                     for c in v.to_numpy()], dtype=object)


class Word2VecModel(Model):
    algo_name = "word2vec"

    def __init__(self, params, output, vocab, vectors, key=None):
        self.vocab = vocab          # word -> index
        self.vectors = vectors      # (V, D) float32 numpy array
        self._norm = vectors / np.maximum(
            np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "Word2VecModel":
        """Carry a JAX-trained Word2Vec over: the vocabulary and the
        vectors (host arrays in both packages)."""
        out = ModelOutput.carried(ref.output)
        rp = ref.params
        params = Word2VecParameters(
            vec_size=rp.vec_size, window_size=rp.window_size,
            min_word_freq=rp.min_word_freq, epochs=rp.epochs,
            negative_samples=rp.negative_samples,
            init_learning_rate=rp.init_learning_rate,
            sent_sample_rate=rp.sent_sample_rate, device=device)
        return Word2VecModel(params, out, dict(ref.vocab),
                             np.array(ref.vectors, np.float32))

    def find_synonyms(self, word: str, count: int = 10) -> dict:
        if word not in self.vocab:
            return {}
        q = self._norm[self.vocab[word]]
        sims = self._norm @ q
        order = np.argsort(-sims)
        inv = list(self.vocab)
        out = {}
        for i in order:
            w = inv[i]
            if w != word:
                out[w] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, words: Vec, aggregate_method: str = "NONE") -> Frame:
        """word column -> embedding columns; AVERAGE pools NA-delimited runs.
        The columns land on the word column's device, else on the
        parameters' device (default cuda)."""
        host = _words(words)
        D = self.vectors.shape[1]
        idx = np.array([self.vocab.get(w, -1) if w is not None else -1
                        for w in host], dtype=np.int64)
        vecs = np.full((len(host), D), np.nan, dtype=np.float32)
        known = idx >= 0
        vecs[known] = self.vectors[idx[known]]
        if aggregate_method.upper() == "AVERAGE":
            rows = []
            cur = []
            for i, w in enumerate(host):
                if w is None:
                    rows.append(np.nanmean(cur, axis=0) if cur else
                                np.full(D, np.nan))
                    cur = []
                elif known[i]:
                    cur.append(vecs[i])
            if cur:
                rows.append(np.nanmean(cur, axis=0))
            vecs = np.stack(rows) if rows else np.zeros((0, D), np.float32)
        dev = words.device or resolve_device(self.params.device)
        names = [f"C{j+1}" for j in range(D)]
        return Frame(names, [Vec.from_numpy(vecs[:, j], device=dev)
                             for j in range(D)])


def _sgns_step(W, C, centers, contexts, negs, lr):
    """One negative-sampling batch: centers (B,), contexts (B,), negs (B, K)
    int64 on W's device; updates W and C in place. Scores clamp at ±6 like
    the canonical word2vec MAX_EXP table."""
    wc = W[centers]                     # (B, D)
    cc = C[contexts]                    # (B, D)
    cn = C[negs]                        # (B, K, D)

    pos_score = torch.clamp(torch.sum(wc * cc, dim=1), -6.0, 6.0)
    neg_score = torch.clamp(torch.einsum("bd,bkd->bk", wc, cn), -6.0, 6.0)
    gpos = torch.sigmoid(pos_score) - 1.0          # (B,)
    gneg = torch.sigmoid(neg_score)                # (B, K)

    gw = gpos[:, None] * cc + torch.einsum("bk,bkd->bd", gneg, cn)
    gc_pos = gpos[:, None] * wc
    gc_neg = gneg[:, :, None] * wc[:, None, :]

    # each word's summed update scaled by 1/sqrt(its batch multiplicity):
    # counts as sums of ones, exact in float32 in any order (``bincount``
    # would wait for the device to size its output)
    V = W.shape[0]
    negs_flat = negs.reshape(-1)
    ones = torch.ones(negs_flat.shape[0], dtype=torch.float32,
                      device=W.device)
    B = centers.shape[0]
    cnt_w = W.new_zeros(V).index_add_(0, centers, ones[:B])
    cnt_c = (W.new_zeros(V).index_add_(0, contexts, ones[:B])
             + W.new_zeros(V).index_add_(0, negs_flat, ones))
    sw = torch.rsqrt(torch.clamp_min(cnt_w, 1.0))
    sc = torch.rsqrt(torch.clamp_min(cnt_c, 1.0))

    _scatter_add(W, centers, -lr * gw * sw[centers][:, None])
    _scatter_add(C, contexts, -lr * gc_pos * sc[contexts][:, None])
    _scatter_add(C, negs_flat, -lr * gc_neg.reshape(-1, W.shape[1])
                 * sc[negs_flat][:, None])


def _scatter_add(dst, idx, rows):
    """dst[idx[i]] += rows[i] for every i, deterministically: on a CPU
    tensor ``index_add_``, which adds the rows one after another in index
    order (XLA's CPU scatter order); on a CUDA tensor
    ``index_put_(accumulate=True)``, which stable-sorts the indices and sums
    each index's rows in that order (``index_add_`` there is float
    atomics)."""
    if dst.device.type == "cuda":
        dst.index_put_((idx,), rows, accumulate=True)
    else:
        dst.index_add_(0, idx, rows)


class _Stepper:
    """One SGNS step on (W, C) from a batch's rows of the pair table, its
    negatives and its learning rate. On a CPU tensor it calls
    ``_sgns_step``; on a CUDA tensor it replays one CUDA graph of the
    gather and ``_sgns_step``, captured once over fixed input buffers (the
    step's ~45 launches cost the host ~0.85 ms while the card works for
    ~0.17; the replay, bit-equal to them, ~0.2 ms)."""

    def __init__(self, W, C, pairs, B: int, K: int):
        self.W, self.C, self.pairs = W, C, pairs
        self.graph = None
        if W.device.type != "cuda":
            return
        dev = W.device
        self.sel = torch.zeros(B, dtype=torch.int64, device=dev)
        self.negs = torch.zeros((B, K), dtype=torch.int64, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        # warm up on copies (the capture runs nothing), off the main stream
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            Wt, Ct = W.clone(), C.clone()
            for _ in range(2):
                self._body(Wt, Ct)
        torch.cuda.current_stream(dev).wait_stream(side)
        del Wt, Ct
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body(W, C)

    def _body(self, W, C):
        batch = self.pairs[self.sel]
        _sgns_step(W, C, batch[:, 0], batch[:, 1], self.negs, self.lr)

    def __call__(self, sel, negs, lr: float):
        if self.graph is None:
            batch = self.pairs[sel]
            _sgns_step(self.W, self.C, batch[:, 0], batch[:, 1], negs, lr)
            return
        self.sel.copy_(sel)
        self.negs.copy_(negs)
        self.lr.fill_(lr)
        self.graph.replay()


def _training_pairs(ids: np.ndarray, window: int) -> np.ndarray:
    """The reference's pair list without its Python loop: for each
    in-vocabulary token t (ids >= 0; -2 ends a sentence, -1 is skipped)
    and each of the up to ``window`` in-vocabulary tokens u before it in
    its sentence, oldest first, the rows (t, u) and (u, t). (P, 2) int32."""
    keep = ids != -1
    seq = ids[keep]
    is_tok = seq >= 0
    # sentence start (in token positions) of each token
    sent = np.cumsum(~is_tok)
    toks = seq[is_tok]
    sid = sent[is_tok]
    pos = np.arange(toks.shape[0])
    first = np.zeros(toks.shape[0], dtype=np.int64)
    if toks.shape[0]:
        starts = np.r_[0, np.flatnonzero(np.diff(sid)) + 1]
        first = np.repeat(starts, np.diff(np.r_[starts, toks.shape[0]]))
    # j = i - window + c, c ascending: u from the oldest to the newest
    js = pos[:, None] - window + np.arange(window)[None, :]
    valid = js >= first[:, None]
    ii = np.broadcast_to(pos[:, None], js.shape)[valid]
    jj = js[valid]
    out = np.empty((ii.shape[0], 2, 2), dtype=np.int32)
    out[:, 0, 0] = toks[ii]
    out[:, 0, 1] = toks[jj]
    out[:, 1, 0] = toks[jj]
    out[:, 1, 1] = toks[ii]
    return out.reshape(-1, 2)


class Word2Vec(ModelBuilder):
    algo_name = "word2vec"
    supervised = False

    def _validate(self):
        if self.params.pre_trained is not None:
            if self.params.training_frame is None:
                self.params.training_frame = self.params.pre_trained
            return
        super()._validate()

    def build_impl(self, job) -> Word2VecModel:
        p: Word2VecParameters = self.params
        if p.pre_trained is not None:
            return self._from_pretrained(p)
        fr = p.training_frame
        dev = fr.device or resolve_device(p.device)
        host = _words(fr.vec(0))

        # the vocabulary above min_word_freq (reference buildVocab)
        counts = Counter(w for w in host if w is not None)
        vocab = {w: i for i, (w, c) in enumerate(
            sorted(counts.items(), key=lambda kv: -kv[1]))
            if c >= p.min_word_freq}
        V = len(vocab)
        if V == 0:
            raise ValueError("word2vec: no words above min_word_freq")

        rng = np.random.default_rng(p.seed if p.seed not in (-1, None)
                                    else 1234)
        ids = np.array([vocab.get(w, -1) if w is not None else -2
                        for w in host], dtype=np.int64)
        pairs = _training_pairs(ids, p.window_size)
        if not len(pairs):
            raise ValueError("word2vec: no training pairs (windows empty)")
        freqs = np.bincount(ids[ids >= 0], minlength=V).astype(np.float64)

        # unigram^0.75 negative-sampling table (the standard SGNS one)
        probs = freqs ** 0.75
        probs = probs / probs.sum()

        D = p.vec_size
        key = threefry.prng_key(int(rng.integers(2**31)))
        W = (threefry.uniform(key, (V, D), dev) - 0.5) / D
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        pairs_d = torch.from_numpy(pairs.astype(np.int64)).to(dev)

        # B <= len(pairs), so every step's slice of the epoch's order is a
        # full batch (the reference's padding never runs)
        B = min(1024, len(pairs))
        K = p.negative_samples
        steps_per_epoch = max(len(pairs) // B, 1)
        total = int(p.epochs) * steps_per_epoch
        step = _Stepper(W, C, pairs_d, B, K)
        s = 0
        for _ in range(int(p.epochs)):
            job.check_cancelled()
            order = torch.from_numpy(rng.permutation(len(pairs))).to(dev)
            for c0 in range(0, steps_per_epoch, _NEG_CHUNK):
                n = min(_NEG_CHUNK, steps_per_epoch - c0)
                # the reference's per-step choice(V, (B, K)) calls, drawn
                # at once: the same uniforms in the same order
                negs = torch.from_numpy(rng.choice(
                    V, size=(n * B, K), p=probs)).to(dev).view(n, B, K)
                for i in range(n):
                    # linear lr decay to ~0, the canonical schedule
                    lr = float(np.float32(p.init_learning_rate
                                          * max(1.0 - s / total, 1e-4)))
                    step(order[(c0 + i) * B:(c0 + i + 1) * B], negs[i], lr)
                    s += 1
                job.update(n / total)

        output = ModelOutput()
        output.model_category = "WordEmbedding"
        output.scoring_history = [{"steps": total, "pairs": len(pairs)}]
        return Word2VecModel(p, output, vocab, W.cpu().numpy())

    def _from_pretrained(self, p) -> Word2VecModel:
        """Import external embeddings: a frame of [Word, V1..VD]
        (`Word2Vec.java` pre-trained model path)."""
        fr = p.pre_trained
        p.vec_size = fr.ncol - 1  # the embedding width comes from the frame
        words = _words(fr.vec(0))
        W = np.stack([fr.vec(j).to_numpy() for j in range(1, fr.ncol)],
                     axis=1).astype(np.float32)
        vocab = {}
        keep = []
        for i, w in enumerate(words):
            if w is not None and w not in vocab:
                vocab[w] = len(vocab)
                keep.append(i)
        output = ModelOutput()
        output.model_category = "WordEmbedding"
        return Word2VecModel(p, output, vocab, W[keep])
