"""On-device CIDEr-D: the SCST reward computed with tensor ops on the card.

Port of ``captioning_tpu/ops/cider_device.py``, which is plain jnp (no
Pallas kernel), so here it is plain PyTorch on the captioner's device.  The
semantics are those of ``utils/cider_scorer.py`` reformulated over
fixed-shape token matrices:

* every n-gram (n = 1..4) at position p of a sequence carries a 64-bit hash
  (two independent 32-bit lanes); multiplicities and clipped tf-idf dot
  products come from position-pairwise equality instead of hash maps:
  norm^2 = sum_i c_i * idf_i^2 and dot = sum_i min(c_i, m_i) * m_i *
  idf_i^2 / c_i, where c_i / m_i are the candidate / reference
  multiplicities of position i's n-gram;
* the document frequencies live in a device-resident table sorted by the
  first lane, probed with ``searchsorted`` and a linear window for the
  second lane;
* a sequence ends at (and includes) its first 0 token (``array_to_str``);
  its length for the gaussian penalty is its bigram count.

The hashes are uint32 arithmetic modulo 2^32.  Torch has no full uint32
arithmetic on CUDA, so they are held in int64 in [0, 2^32) and each
multiply splits the hash into 16-bit halves so no product leaves int64;
they equal the JAX package's bit for bit (tests/test_torch_cider_device.py).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

MAX_N = 4
SIGMA = 6.0
_M1 = 1000003
_M2 = 2654435761
_MASK = 0xFFFFFFFF
_PROBE = 8  # linear probe window after searchsorted


def _host_hash_ngram(tokens, lane: int) -> int:
    m = _M1 if lane == 0 else _M2
    h = (len(tokens) * 2166136261 + (7 if lane else 3)) & _MASK
    for t in tokens:
        h = (h * m + (int(t) + 1)) & _MASK
    return h


def _mul_add(h, m: int, x):
    """(h * m + x) mod 2^32 for int64 tensors h, x in [0, 2^32): h's 16-bit
    halves are multiplied apart, so every product stays below 2^48."""
    hi, lo = h >> 16, h & 0xFFFF
    return ((((hi * m) & 0xFFFF) << 16) + lo * m + x) & _MASK


def _tree(fn, stats):
    return {k: fn(v) for k, v in stats.items()}


class DeviceCiderD:
    """The df table on ``device`` and the scoring functions."""

    def __init__(self, df_pkl_or_dict, ref_len=None, device='cuda'):
        if isinstance(df_pkl_or_dict, str):
            path = (df_pkl_or_dict
                    if df_pkl_or_dict.endswith(('.p', '.pkl'))
                    else 'data/%s.p' % df_pkl_or_dict)
            with open(path, 'rb') as f:
                pkl = pickle.load(f, encoding='latin-1')
            df = pkl['document_frequency']
            ref_len = float(pkl['ref_len'])
        else:
            df = df_pkl_or_dict
            if ref_len is None:
                raise ValueError('a df dict needs its ref_len')
        self.device = torch.device(device)
        self.log_ref_len = float(np.log(ref_len))

        h1, h2, dfv = [], [], []
        for ngram, d in df.items():
            ids = [int(t) for t in ngram]
            h1.append(_host_hash_ngram(ids, 0))
            h2.append(_host_hash_ngram(ids, 1))
            dfv.append(float(d))
        h1 = np.asarray(h1, np.int64)
        h2 = np.asarray(h2, np.int64)
        dfv = np.asarray(dfv, np.float32)
        order = np.argsort(h1, kind='stable')
        self.table_h1 = torch.from_numpy(h1[order]).to(self.device)
        self.table_h2 = torch.from_numpy(h2[order]).to(self.device)
        self.table_df = torch.from_numpy(dfv[order]).to(self.device)

    # -- device-side pieces -------------------------------------------------
    def _ngram_hashes(self, seqs):
        """seqs [N, L] -> (h1, h2, valid) each [N, MAX_N, L], eff_len [N].

        Position (n-1, p) is the hash of the n-gram starting at p; valid
        only when p + n <= effective length (first 0 inclusive).  The
        tail's n-grams wrap onto the head (``roll``, as ``jnp.roll``) and
        are masked by ``valid``."""
        N, L = seqs.shape
        seqs = seqs.long()
        tok = seqs + 1
        is_zero = seqs == 0
        first_zero = torch.argmax(is_zero.int(), dim=1)
        eff_len = torch.where(is_zero.any(1), first_zero + 1,
                              torch.full_like(first_zero, L))

        h1s, h2s = [], []
        for n in range(1, MAX_N + 1):
            h1 = torch.full((N, L), (n * 2166136261 + 3) & _MASK,
                            dtype=torch.long, device=seqs.device)
            h2 = torch.full((N, L), (n * 2166136261 + 7) & _MASK,
                            dtype=torch.long, device=seqs.device)
            for k in range(n):
                shifted = torch.roll(tok, -k, dims=1)
                h1 = _mul_add(h1, _M1, shifted)
                h2 = _mul_add(h2, _M2, shifted)
            h1s.append(h1)
            h2s.append(h2)
        h1 = torch.stack(h1s, 1)   # [N, MAX_N, L]
        h2 = torch.stack(h2s, 1)
        pos = torch.arange(L, device=seqs.device)[None, None, :]
        nn = torch.arange(1, MAX_N + 1, device=seqs.device)[None, :, None]
        valid = (pos + nn) <= eff_len[:, None, None]
        return h1, h2, valid, eff_len

    def _idf(self, h1, h2):
        """log-idf of each hash (ref_len's log where the n-gram is
        unseen)."""
        shape = h1.shape
        f1 = h1.reshape(-1)
        f2 = h2.reshape(-1)
        idx = torch.searchsorted(self.table_h1, f1)
        T = self.table_h1.shape[0]
        dfv = torch.zeros(f1.shape, dtype=torch.float32, device=f1.device)
        found = torch.zeros(f1.shape, dtype=torch.bool, device=f1.device)
        for k in range(_PROBE):
            j = (idx + k).clamp_max(T - 1)
            hit = ~found & (self.table_h1[j] == f1) & (self.table_h2[j] == f2)
            dfv = torch.where(hit, self.table_df[j], dfv)
            found = found | hit
        idf = self.log_ref_len - torch.log(dfv.clamp_min(1.0))
        return idf.reshape(shape)

    @staticmethod
    def _multiplicity(h1a, h2a, va, h1b, h2b, vb):
        """For each n-gram position of a, its multiplicity in b, within
        the same n (a: [..., MAX_N, L]; b broadcast-compatible)."""
        eq = ((h1a[..., :, None] == h1b[..., None, :]) &
              (h2a[..., :, None] == h2b[..., None, :]) &
              vb[..., None, :])
        return eq.sum(-1).float() * va

    def sentence_stats(self, seqs):
        """(h1, h2, valid, count, idf, norm, length) of each row."""
        h1, h2, valid, _ = self._ngram_hashes(seqs)
        count = self._multiplicity(h1, h2, valid.float(), h1, h2, valid)
        idf = self._idf(h1, h2) * valid
        norm = torch.sqrt((count * idf * idf).sum(-1))     # [N, MAX_N]
        length = valid[:, 1, :].sum(-1).float()
        return dict(h1=h1, h2=h2, valid=valid, count=count, idf=idf,
                    norm=norm, length=length)

    def pair_scores(self, cand, ref):
        """CIDEr-D of aligned candidate / reference stats whose leading
        dims broadcast (already x 10 / MAX_N and the length gaussian)."""
        m = self._multiplicity(cand['h1'], cand['h2'], cand['valid'].float(),
                               ref['h1'], ref['h2'], ref['valid'])
        c = cand['count']
        contrib = torch.where(
            c > 0, torch.minimum(c, m) * m * cand['idf'] ** 2
            / c.clamp_min(1.0), 0.0)
        dot = contrib.sum(-1)                            # [..., MAX_N]
        denom = cand['norm'] * ref['norm']
        sim = torch.where(denom > 0, dot / denom.clamp_min(1e-12), 0.0)
        delta = cand['length'] - ref['length']
        gauss = torch.exp(-(delta * delta) / (2 * SIGMA * SIGMA))
        return sim.sum(-1) * gauss * (10.0 / MAX_N)

    def score(self, cands, refs, ref_mask):
        """cands [N, L]; refs [N, R, Lr] (one reference set a candidate);
        ref_mask [N, R] -> CIDEr-D [N]; masked references are left out of
        the mean."""
        N, R, Lr = refs.shape
        c_stats = self.sentence_stats(cands)
        r_stats = _tree(lambda x: x.reshape((N, R) + x.shape[1:]),
                        self.sentence_stats(refs.reshape(N * R, Lr)))
        per_ref = self.pair_scores(_tree(lambda x: x[:, None], c_stats),
                                   r_stats) * ref_mask
        return per_ref.sum(-1) / ref_mask.sum(-1).clamp_min(1.0)

    def _bleu4_grouped(self, c_stats, r_stats, ref_mask):
        """Per-sentence BLEU-4 of cand stats [B, k, ...] against ref stats
        [B, R, ...] -> [B, k]: ``utils/cider_scorer.py:Bleu``'s semantics
        (tiny / small smoothing, the closest reference length with ties to
        the shorter), in log space so the smoothed products stay inside
        float32's range."""
        small, tiny = 1e-9, 1e-15
        m = self._multiplicity(
            c_stats['h1'][:, :, None], c_stats['h2'][:, :, None],
            c_stats['valid'][:, :, None].float(),
            r_stats['h1'][:, None], r_stats['h2'][:, None],
            r_stats['valid'][:, None])                  # [B, k, R, n, L]
        m = m * ref_mask[:, None, :, None, None]
        rmax = m.max(2).values                          # [B, k, n, L]
        c = c_stats['count']
        # the sum over positions of min(c, rmax) / c is the sum over n-gram
        # types of min(c, rmax): the clipped correct counts a n
        correct = torch.where(c > 0, torch.minimum(c, rmax)
                              / c.clamp_min(1.0), 0.0).sum(-1)  # [B, k, n]
        guess = c_stats['valid'].sum(-1).float()
        testlen = guess[..., 0]                         # [B, k]
        rlen = r_stats['valid'][..., 0, :].sum(-1)      # [B, R]
        big = r_stats['valid'].shape[-1] + 2
        diff = (rlen[:, None, :] - testlen.long()[:, :, None]).abs()
        key = diff * big + rlen[:, None, :]
        key = torch.where(ref_mask[:, None, :] > 0, key, 2 ** 30)
        reflen = (key.min(-1).values % big).float()
        log_prec = torch.log(correct + tiny) - torch.log(guess + small)
        ratio = (testlen + tiny) / (reflen + small)
        log_bp = torch.where(ratio < 1, 1.0 - 1.0 / ratio.clamp_min(tiny),
                             0.0)
        return torch.exp(log_prec.sum(-1) / MAX_N + log_bp)

    def _mean_score_grouped(self, c_stats, r_stats, ref_mask):
        """cand stats [B, k, ...] x ref stats [B, R, ...] -> [B, k]."""
        per_ref = self.pair_scores(_tree(lambda x: x[:, :, None], c_stats),
                                   _tree(lambda x: x[:, None], r_stats))
        per_ref = per_ref * ref_mask[:, None]
        return per_ref.sum(-1) / ref_mask.sum(-1).clamp_min(1.0)[:, None]

    def _mixed_score_grouped(self, c_stats, r_stats, ref_mask,
                             cider_weight, bleu_weight):
        """cider_weight * CIDEr-D + bleu_weight * BLEU-4 over grouped
        stats; a zero weight leaves its scorer out."""
        out = torch.zeros(c_stats['norm'].shape[:2], dtype=torch.float32,
                          device=c_stats['norm'].device)
        if cider_weight:
            out = self._mean_score_grouped(c_stats, r_stats,
                                           ref_mask) * cider_weight
        if bleu_weight:
            out = out + self._bleu4_grouped(c_stats, r_stats,
                                            ref_mask) * bleu_weight
        return out

    def _grouped(self, seqs, groups):
        """sentence_stats of seqs [groups * k, L] as [groups, k, ...]."""
        return _tree(lambda x: x.reshape((groups, -1) + x.shape[1:]),
                     self.sentence_stats(seqs))

    def score_grouped(self, cands, refs, ref_mask, n: int,
                      cider_weight: float = 1.0, bleu_weight: float = 0.0):
        """cands [B*n, L]; refs [B, R, Lr]; ref_mask [B, R] -> [B*n]
        (cider_weight * CIDEr-D + bleu_weight * BLEU-4): ``score`` over the
        references repeated n times, with each image's reference stats
        computed once."""
        B, R, Lr = refs.shape
        r_stats = self._grouped(refs.reshape(B * R, Lr), B)
        return self._mixed_score_grouped(
            self._grouped(cands, B), r_stats, ref_mask, cider_weight,
            bleu_weight).reshape(B * n)

    def self_critical_reward(self, greedy, gen, refs, ref_mask,
                             cider_weight: float = 1.0,
                             bleu_weight: float = 0.0):
        """``get_self_critical_reward`` on the card: greedy [B, L]; gen
        [B*n, L]; refs [B, R, Lr]; ref_mask [B, R] -> each sample's mixed
        score less its image's greedy score, tiled over time [B*n, L].
        The reference stats are computed once, for the samples and the
        baseline."""
        B = greedy.shape[0]
        N = gen.shape[0]
        R, Lr = refs.shape[1], refs.shape[2]
        r_stats = self._grouped(refs.reshape(B * R, Lr), B)
        s_gen = self._mixed_score_grouped(
            self._grouped(gen, B), r_stats, ref_mask, cider_weight,
            bleu_weight)                                    # [B, n]
        s_greedy = self._mixed_score_grouped(
            self._grouped(greedy, B), r_stats, ref_mask, cider_weight,
            bleu_weight)[:, 0]
        adv = (s_gen - s_greedy[:, None]).reshape(N)
        return adv[:, None].expand(N, gen.shape[1]).contiguous()

    def self_cider_grouped(self, gen, n: int):
        """The self-CIDEr diversity reward on the card: gen [B*n, L] ->
        [B].  Per image, the plain-Cider Gram matrix of its n samples,
        G[i, j] = mean_k <tf_i idf, tf_j idf>_k / (norm_i,k norm_j,k) (each
        position p of i contributes mult_j(p) * idf_p^2, so the sum over
        positions carries tf_i), then -log(sqrt(l_max) / sum sqrt(l_+)) /
        log(n) over the eigenvalues of G (ascending, clipped at 0).  Plain
        Cider has no clipping and no length gaussian."""
        N = gen.shape[0]
        g = self._grouped(gen, N // n)
        a = _tree(lambda x: x[:, :, None], g)           # [B, n, 1, ...]
        b = _tree(lambda x: x[:, None], g)              # [B, 1, n, ...]
        m = self._multiplicity(a['h1'], a['h2'], a['valid'].float(),
                               b['h1'], b['h2'], b['valid'])
        dot = (m * a['idf'] ** 2).sum(-1)               # [B, n, n, MAX_N]
        denom = a['norm'] * b['norm']
        sim = torch.where(denom > 0, dot / denom.clamp_min(1e-12), 0.0)
        gram = sim.mean(-1)                             # [B, n, n]
        lam = torch.linalg.eigvalsh(gram).clamp_min(0.0)
        sq = torch.sqrt(lam)                            # ascending
        ssum = sq.sum(-1)
        ratio = torch.where(ssum > 0, sq[..., -1] / ssum.clamp_min(1e-12),
                            1.0)
        return -torch.log(ratio.clamp_min(1e-12)) / float(np.log(n))


def pad_gts(data_gts, pad_to_multiple: int = 1):
    """Host helper: a list of [n_i, Lr] int arrays -> (refs [B, R, Lr]
    int32, mask [B, R] float32) with R = max n_i, rounded up to a multiple
    of ``pad_to_multiple``."""
    B = len(data_gts)
    R = max(len(g) for g in data_gts)
    if pad_to_multiple > 1:
        R = -(-R // pad_to_multiple) * pad_to_multiple
    Lr = max(np.asarray(g).shape[1] for g in data_gts)
    refs = np.zeros((B, R, Lr), np.int32)
    mask = np.zeros((B, R), np.float32)
    for i, g in enumerate(data_gts):
        g = np.asarray(g, np.int32)
        refs[i, :g.shape[0], :g.shape[1]] = g
        mask[i, :g.shape[0]] = 1.0
    return refs, mask
