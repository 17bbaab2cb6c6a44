"""The paged engine's prefix walk under a full pool (ROADMAP § C, C5/C6).

C5: the walk must hold each page it finds from the moment it finds it.  A
host-tier hit later in the same walk allocates a page for its restore;
with the free list empty that alloc evicts the least recently used
reclaimable page, which, when every reclaimable page is this walk's, is a
page the walk already mapped.  The evict hook then spills it over the
host copy the restore is about to read (a one-page host pool), and the
slot would map a page whose bytes were reused.

C6: a restore's alloc can evict a page the walk has not reached (or any
other reclaimable page) whose demotion drops, from a full host pool, the
very key being restored.  The restore must then give up (the tail
re-prefills) instead of reading a host slot that is gone.

Each case fills the pool, admits the prompt again with the free list
empty, asserts the allocator's invariants and that the admission backs
off with ``OutOfPages`` (nothing mapped), then serves the prompt once
room frees and holds its tokens to an engine with the prefix cache off.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    init_params,
)
from distributeddeeplearning_tpu_torch.serve import PagedInferenceEngine
from distributeddeeplearning_tpu_torch.serve.kv_cache import OutOfPages

CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
PS = 4           # page size
NEW = 3          # new tokens a request
# 13 tokens: three full prompt pages, all three on the walk ((13-1)//4),
# and four pages with the token budget
PROMPT = [(7 * i + 3) % CFG["vocab_size"] for i in range(13)]
OTHER = [(11 * i + 5) % CFG["vocab_size"] for i in range(13)]


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), **CFG, device="cpu")


def _engine(params, *, prefix_cache=True, host_pages=1, num_pages=6):
    return PagedInferenceEngine(
        params, num_heads=CFG["num_heads"], batch_slots=2, max_seq=32,
        page_size=PS, num_pages=num_pages, prefill_chunk=PS,
        prefix_cache=prefix_cache, host_pages=host_pages, device="cpu",
    )


def _greedy(eng, slot: int, prompt, n: int = NEW):
    """Serve ``prompt`` alone in ``slot``: prefill, then ``n - 1`` decode
    steps (the other slot's row is scratch); releases the slot."""
    tok = eng.prefill(slot, prompt, n)
    out = [tok]
    tokens = np.zeros(eng.batch_slots, np.int32)
    pos = np.zeros(eng.batch_slots, np.int32)
    for i in range(n - 1):
        tokens[slot], pos[slot] = tok, len(prompt) + i
        tok = int(eng.decode(tokens, pos)[slot])
        out.append(tok)
    eng.release(slot)
    return out


def _key(n_pages: int):
    return tuple(PROMPT[: n_pages * PS])


@pytest.mark.parametrize("case", ["C5_walk_owns_every_page", "C6_restore_key_dropped"])
def test_prefix_walk_under_full_pool(params, case):
    ref = _greedy(_engine(params, prefix_cache=False, host_pages=0), 0, PROMPT)
    eng = _engine(params)
    alloc = eng.allocator
    assert _greedy(eng, 0, PROMPT) == ref
    # the prompt's three full pages stay reclaimable under keys 1..3
    assert alloc.reclaimable_pages == 3 and alloc.free_pages == 3
    if case == "C5_walk_owns_every_page":
        # spill the LAST page: the two resident pages are all the
        # reclaimable pages there are, and both are on the walk
        alloc.lookup_prefix(_key(1))
        alloc.lookup_prefix(_key(2))
    else:
        # spill the MIDDLE page: the third (not yet walked when the
        # restore allocates) is the LRU page the restore's alloc evicts
        alloc.lookup_prefix(_key(1))
    assert eng.spill_cold_pages(1) == 1
    spilled = 3 if case == "C5_walk_owns_every_page" else 2
    assert alloc.tier_state(_key(spilled)) == "host"
    # another request takes every free page: the free list is empty
    eng.prefill_begin(1, OTHER, NEW)
    assert alloc.free_pages == 0 and alloc.reclaimable_pages == 2
    with pytest.raises(OutOfPages):
        eng.prefill_begin(0, PROMPT, NEW)
    alloc.check()
    eng.tier.check()
    assert 0 not in eng._slot_pages
    # room frees: the prompt is served and its tokens are the reference's
    eng.release(1)
    alloc.check()
    assert _greedy(eng, 0, PROMPT) == ref
    alloc.check()
    eng.tier.check()
