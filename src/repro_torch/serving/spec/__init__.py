"""Speculative decoding on the paged KV pool (counterpart of
``repro.serving.spec``).

Decode is memory-bound (the paper's claim): a decode step at small batch
streams the weights and the KV to produce one token a request. Speculative
decoding spends the idle compute verifying drafted tokens in one step.

* :class:`Drafter` / :class:`PromptLookupDrafter` (``drafter.py``): where
  the candidates come from, an n-gram match over the request's own prompt
  and output, with a proposal length adapted a request.
* :func:`spec_verify_body` (``verify.py``): the verify step, ``K + 1``
  exact serial decode iterations with the acceptance gating on the
  device, replayed from one CUDA graph a bucket by
  :meth:`~repro_torch.serving.steps.StepFunctions.verify`.
* token-granular rollback: :meth:`PagedKVCache.rollback
  <repro_torch.kvcache.paged.PagedKVCache.rollback>` releases the table
  tail reserved for drafts that did not commit.

The scheduler plans drafts and reserves their span; the engine and the
executor commit a variable number of tokens a row.
"""
from repro_torch.serving.spec.drafter import Drafter, PromptLookupDrafter
from repro_torch.serving.spec.verify import spec_verify_body, stack_drafts

__all__ = ["Drafter", "PromptLookupDrafter", "spec_verify_body",
           "stack_drafts"]
