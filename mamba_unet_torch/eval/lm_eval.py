"""LM evaluation harness for the Mamba language model.

Port of ``mamba_unet_tpu/eval/lm_eval.py`` (the reference's
``evals/lm_harness_eval.py``, which hands ``MambaLMHeadModel`` to
lm-evaluation-harness). The harness's request primitives are implemented
directly:

  * ``loglikelihood(context_ids, continuation_ids)``: the sum of
    continuation-token log-probs given the context, and the ``is_greedy``
    exact-match flag (``lm_eval.api.model.LM.loglikelihood`` semantics);
  * multiple-choice accuracy (``acc``: best raw loglikelihood;
    ``acc_norm``: best per-token-normalized) and lambada-style last-word
    accuracy and perplexity;
  * token-level ``generate_until``.

Requests are sorted by length, padded on the right to shape buckets and
scored ``batch_size`` rows per forward. The evaluator runs wherever its
model's parameters lie: on the card unless it is given a CPU model. If
``lm_eval`` is importable, ``make_harness_adapter`` returns an ``LM``
subclass delegating to the same scorer.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _bucket(n: int, sizes=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return -(-n // 1024) * 1024


class LMEvaluator:
    """Batched, bucketed loglikelihood scoring of a ``MambaLMHeadModel``."""

    def __init__(self, model, batch_size: int = 8):
        self.model = model.eval()
        self.batch_size = batch_size
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def _score(self, ids: torch.Tensor, cont_mask: torch.Tensor):
        """ids (B, L), cont_mask (B, L): 1 on continuation tokens. Returns
        (sum log-prob of the continuation, greedy-match flag) per row.
        Token t is predicted from the logits at t - 1."""
        logp = self.model(ids)[:, :-1].log_softmax(dim=-1)
        tgt = ids[:, 1:]
        m = cont_mask[:, 1:].bool()
        tok_lp = logp.gather(-1, tgt[..., None])[..., 0]
        ll = (tok_lp * m).sum(dim=-1)
        greedy = logp.argmax(dim=-1) == tgt
        return ll, (greedy | ~m).all(dim=-1)

    def loglikelihood(
        self, requests: Sequence[Tuple[Sequence[int], Sequence[int]]]
    ) -> List[Tuple[float, bool]]:
        """requests: [(context_ids, continuation_ids)]. Returns
        [(loglikelihood, is_greedy)] in order, batched per length bucket."""
        order = sorted(range(len(requests)),
                       key=lambda i: len(requests[i][0]) + len(requests[i][1]))
        out: List = [None] * len(requests)
        bs = self.batch_size
        for s in range(0, len(order), bs):
            idxs = order[s: s + bs]
            L = _bucket(max(len(requests[i][0]) + len(requests[i][1])
                            for i in idxs))
            ids = np.zeros((bs, L), np.int64)
            mask = np.zeros((bs, L), np.int64)
            for r, i in enumerate(idxs):
                ctx, cont = requests[i]
                seq = list(ctx) + list(cont)
                ids[r, : len(seq)] = seq
                mask[r, len(ctx): len(seq)] = 1
            ll, greedy = self._score(torch.from_numpy(ids).to(self.device),
                                     torch.from_numpy(mask).to(self.device))
            ll, greedy = ll.cpu().numpy(), greedy.cpu().numpy()
            for r, i in enumerate(idxs):
                out[i] = (float(ll[r]), bool(greedy[r]))
        return out

    # --- task drivers ----------------------------------------------------
    def multiple_choice(self, docs) -> dict:
        """docs: [{"context": ids, "choices": [ids...], "gold": int}].
        Returns {"acc", "acc_norm"} (lm-harness multiple-choice metrics)."""
        reqs, spans = [], []
        for d in docs:
            start = len(reqs)
            reqs.extend((d["context"], c) for c in d["choices"])
            spans.append((start, len(reqs)))
        scores = self.loglikelihood(reqs)
        acc = acc_norm = 0
        for d, (start, stop) in zip(docs, spans):
            lls = [scores[j][0] for j in range(start, stop)]
            lens = [max(len(c), 1) for c in d["choices"]]
            acc += int(int(np.argmax(lls)) == d["gold"])
            acc_norm += int(
                int(np.argmax([v / n for v, n in zip(lls, lens)])) == d["gold"]
            )
        n = max(len(docs), 1)
        return {"acc": acc / n, "acc_norm": acc_norm / n}

    def generate_until(
        self,
        requests: Sequence[Tuple[Sequence[int], dict]],
    ) -> List[List[int]]:
        """Each request is ``(context_ids, gen_kwargs)`` with keys ``until``
        (stop-token-id sequences), ``max_gen_toks`` (default 128) and
        ``temperature``/``top_k``/``top_p`` (default greedy). Returns the
        generated ids per request, cut BEFORE the first stop sequence.

        Requests run one at a time at their native context length: an SSM
        cannot left-pad, since pad tokens would flow through the recurrent
        state."""
        from mamba_unet_torch.models.mamba_lm import generate

        out: List[List[int]] = []
        for ctx, kw in requests:
            kw = dict(kw or {})
            ids = torch.tensor([list(ctx)], dtype=torch.long)
            full = generate(
                self.model, ids,
                max_new_tokens=int(kw.get("max_gen_toks", 128)),
                temperature=float(kw.get("temperature", 1.0)),
                top_k=int(kw.get("top_k", 1)),
                top_p=float(kw.get("top_p", 0.0)),
            )
            gen = full[0, len(ctx):].tolist()
            for stop in kw.get("until", []) or []:
                stop = list(stop)
                for i in range(len(gen) - len(stop) + 1):
                    if gen[i: i + len(stop)] == stop:
                        gen = gen[:i]
                        break
            out.append(gen)
        return out

    def lambada(self, docs) -> dict:
        """docs: [{"context": ids, "target": ids}] (the final word's tokens).
        Returns {"acc": greedy exact-match rate, "ppl": e^(-mean ll/token)}."""
        reqs = [(d["context"], d["target"]) for d in docs]
        scores = self.loglikelihood(reqs)
        n_tok = sum(len(d["target"]) for d in docs)
        total_ll = sum(s[0] for s in scores)
        acc = sum(int(s[1]) for s in scores) / max(len(docs), 1)
        return {"acc": acc, "ppl": float(np.exp(-total_ll / max(n_tok, 1)))}


def make_harness_adapter(model, batch_size: int = 8, tokenizer=None):
    """If ``lm_eval`` is installed, return an ``LM`` subclass instance
    delegating to :class:`LMEvaluator`; else raise ``ImportError``.

    ``tokenizer`` (optional, with .encode/.decode) enables string-level
    ``generate_until`` requests as the harness issues them; without it,
    requests must already carry token ids."""
    from lm_eval.api.model import LM  # optional dependency

    ev = LMEvaluator(model, batch_size)

    class MambaTorchLM(LM):
        def loglikelihood(self, requests):
            return ev.loglikelihood(
                [(r.args[0], r.args[1]) for r in requests])

        def loglikelihood_rolling(self, requests):
            return [ev.loglikelihood([((), r.args[0])])[0] for r in requests]

        def generate_until(self, requests):
            outs = []
            for r in requests:
                ctx, kw = r.args[0], dict(r.args[1] or {})
                if tokenizer is not None and isinstance(ctx, str):
                    ids = tokenizer.encode(ctx)
                    until = kw.get("until", []) or []
                    kw["until"] = [tokenizer.encode(u) for u in until]
                    gen, = ev.generate_until([(ids, kw)])
                    text = tokenizer.decode(gen)
                    # token-boundary stops can leave a partial match: cut
                    # again at the string level (HFLM does the same)
                    for u in until:
                        idx = text.find(u)
                        if idx >= 0:
                            text = text[:idx]
                    outs.append(text)
                else:
                    gen, = ev.generate_until([(ctx, kw)])
                    outs.append(gen)
            return outs

    return MambaTorchLM()
