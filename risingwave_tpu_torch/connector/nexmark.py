"""NEXmark event generator — the benchmark source.

Counterpart of ``risingwave_tpu/connector/nexmark.py::NexmarkGenerator``:
vectorized numpy on the host, a whole chunk per call, moved to ``device``.
From the same seed it draws the same numbers in the same order as the
reference, so both packages see the same rows. VARCHAR columns carry ids of
the process-wide ``GLOBAL_STRING_DICT``, into which each generator interns
its strings in the reference's order; ``vocab[id]`` is the dictionary's
strings as of the generator's construction.

``DeviceBidGenerator`` is the benchmark source: bids drawn on the device from
counter-based Threefry keys (``threefry.py``), the same numbers the
reference's ``DeviceBidGenerator`` draws from the same start and key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import ChunkBatch, Column, StreamChunk, map_tensors
from ..common.types import (
    GLOBAL_STRING_DICT, INT64, TIMESTAMP, VARCHAR, Schema,
)
from . import threefry

BID_SCHEMA = Schema.of(
    ("auction", INT64), ("bidder", INT64), ("price", INT64),
    ("channel", VARCHAR), ("url", VARCHAR), ("date_time", TIMESTAMP),
    ("extra", VARCHAR),
)

AUCTION_SCHEMA = Schema.of(
    ("id", INT64), ("item_name", VARCHAR), ("description", VARCHAR),
    ("initial_bid", INT64), ("reserve", INT64), ("date_time", TIMESTAMP),
    ("expires", TIMESTAMP), ("seller", INT64), ("category", INT64),
    ("extra", VARCHAR),
)

PERSON_SCHEMA = Schema.of(
    ("id", INT64), ("name", VARCHAR), ("email_address", VARCHAR),
    ("credit_card", VARCHAR), ("city", VARCHAR), ("state", VARCHAR),
    ("date_time", TIMESTAMP), ("extra", VARCHAR),
)

# NEXmark spec constants
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION
FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10
HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
NUM_CATEGORIES = 5

_CHANNELS = ["Google", "Facebook", "Baidu", "Apple"]
_US_STATES = ["AZ", "CA", "ID", "OR", "WY"]
_CITIES = ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland"]
_URLS = [f"https://www.nexmark.com/item{i}" for i in range(64)]


@dataclasses.dataclass
class NexmarkConfig:
    chunk_capacity: int = 1024
    events_per_second: int = 10_000   # drives event-time spacing
    active_people: int = 1000
    in_flight_auctions: int = 100
    start_time_us: int = 1_600_000_000_000_000


class NexmarkGenerator:
    """Generates Bid / Auction / Person chunks with a shared event clock."""

    def __init__(self, config: NexmarkConfig = NexmarkConfig(),
                 seed: int = 42, device=DEFAULT_DEVICE):
        self.cfg = config
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.events_so_far = 0
        def intern(strings) -> np.ndarray:
            return np.array([GLOBAL_STRING_DICT.intern(s) for s in strings],
                            dtype=np.int32)

        self._channel_ids = intern(_CHANNELS)
        self._url_ids = intern(_URLS)
        self._city_ids = intern(_CITIES)
        self._state_ids = intern(_US_STATES)
        self._name_ids = intern([f"person-{i}" for i in range(997)])
        self._item_ids = intern([f"item-{i}" for i in range(499)])
        self._empty = 0
        self.vocab = _vocab()

    # -- event-time / id helpers ---------------------------------------------

    def _advance(self, n: int):
        """Event timestamps (us) and ids for the next n events."""
        ids = np.arange(self.events_so_far, self.events_so_far + n,
                        dtype=np.int64)
        self.events_so_far += n
        us_per_event = 1_000_000 // max(self.cfg.events_per_second, 1)
        return self.cfg.start_time_us + ids * max(us_per_event, 1), ids

    def _last_auction_id(self, event_ids: np.ndarray) -> np.ndarray:
        return FIRST_AUCTION_ID + (event_ids // TOTAL_PROPORTION) \
            * AUCTION_PROPORTION

    def _last_person_id(self, event_ids: np.ndarray) -> np.ndarray:
        return FIRST_PERSON_ID + (event_ids // TOTAL_PROPORTION) \
            * PERSON_PROPORTION

    def _chunk(self, schema: Schema, arrays: list[np.ndarray],
               n: int) -> StreamChunk:
        cap, dev = self.cfg.chunk_capacity, self.device
        live = torch.as_tensor(np.arange(cap) < n, device=dev)
        cols = []
        for arr, field in zip(arrays, schema):
            buf = np.zeros(cap, field.type.np_dtype)
            buf[:n] = arr.astype(field.type.np_dtype)
            cols.append(Column(torch.as_tensor(buf, device=dev), live))
        ops = torch.zeros(cap, dtype=torch.int8, device=dev)  # append-only
        return StreamChunk(ops, live, tuple(cols))

    # -- streams --------------------------------------------------------------

    def next_bid_chunk(self, n: Optional[int] = None) -> StreamChunk:
        n = n or self.cfg.chunk_capacity
        ts, eids = self._advance(n)
        last_auction = self._last_auction_id(eids)
        last_person = self._last_person_id(eids)
        hot = self.rng.random(n) < 0.9  # hot auctions get ~90% of bids
        hot_auction = (last_auction // HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO
        cold_auction = last_auction - self.rng.integers(
            0, self.cfg.in_flight_auctions, n)
        auction = np.where(hot, hot_auction, cold_auction)
        hot_b = self.rng.random(n) < 0.9
        hot_bidder = (last_person // HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO + 1
        cold_bidder = np.maximum(
            last_person - self.rng.integers(0, self.cfg.active_people, n),
            FIRST_PERSON_ID)
        bidder = np.where(hot_b, hot_bidder, cold_bidder)
        price = (100 * np.exp(self.rng.random(n) * np.log(1000.0))
                 ).astype(np.int64)
        channel = self._channel_ids[
            self.rng.integers(0, len(self._channel_ids), n)]
        url = self._url_ids[self.rng.integers(0, len(self._url_ids), n)]
        extra = np.full(n, self._empty, np.int32)
        return self._chunk(
            BID_SCHEMA, [auction, bidder, price, channel, url, ts, extra], n)

    def next_auction_chunk(self, n: Optional[int] = None) -> StreamChunk:
        n = n or self.cfg.chunk_capacity
        ts, eids = self._advance(n)
        ids = FIRST_AUCTION_ID + np.arange(n, dtype=np.int64) + (
            self._last_auction_id(eids[:1])[0] - FIRST_AUCTION_ID)
        item = self._item_ids[self.rng.integers(0, len(self._item_ids), n)]
        desc = np.full(n, self._empty, np.int32)
        initial = self.rng.integers(1, 1000, n).astype(np.int64)
        reserve = initial + self.rng.integers(0, 1000, n)
        expires = ts + self.rng.integers(1_000_000, 60_000_000, n)
        seller = self._last_person_id(eids)
        category = FIRST_CATEGORY_ID + self.rng.integers(0, NUM_CATEGORIES, n)
        extra = np.full(n, self._empty, np.int32)
        return self._chunk(
            AUCTION_SCHEMA,
            [ids, item, desc, initial, reserve, ts, expires, seller, category,
             extra], n)

    def next_person_chunk(self, n: Optional[int] = None) -> StreamChunk:
        n = n or self.cfg.chunk_capacity
        ts, eids = self._advance(n)
        ids = self._last_person_id(eids)
        name = self._name_ids[self.rng.integers(0, len(self._name_ids), n)]
        email = np.full(n, self._empty, np.int32)
        card = np.full(n, self._empty, np.int32)
        city = self._city_ids[self.rng.integers(0, len(self._city_ids), n)]
        state = self._state_ids[self.rng.integers(0, len(self._state_ids), n)]
        extra = np.full(n, self._empty, np.int32)
        return self._chunk(
            PERSON_SCHEMA, [ids, name, email, card, city, state, ts, extra],
            n)


class DeviceBidGenerator:
    """Bid chunks generated on the device, bit-exact with the reference's
    ``DeviceBidGenerator`` (``risingwave_tpu/connector/nexmark.py``).

    Per chunk the only inputs are the first event id and a Threefry key, so
    generation is replayable from ``(seed, batch_no)`` alone. The draws are
    the reference's, in its order, from ``split(key, 7)``: hot auction
    (uniform < 0.9), cold auction offset, hot bidder, cold bidder offset,
    price (``100 * exp(u * log 1000)`` in float64, truncated), channel and
    url. VARCHAR ids are ``GLOBAL_STRING_DICT`` ids (``vocab[id]``); the
    reference's index its own process dictionary, so compare strings, not
    ids."""

    def __init__(self, config: NexmarkConfig = NexmarkConfig(),
                 seed: int = 42, device=DEFAULT_DEVICE):
        self.cfg = config
        self.device = torch.device(device)
        self.events_so_far = 0
        self._batch_no = 0
        self._seed = seed
        self._channel_ids, self._url_ids = (
            torch.tensor([GLOBAL_STRING_DICT.intern(s) for s in strings],
                         dtype=torch.int32, device=device)
            for strings in (_CHANNELS, _URLS))
        self._empty = 0
        self.vocab = _vocab()

    def _gen_rows(self, starts: torch.Tensor, keys: torch.Tensor,
                  n: int) -> StreamChunk:
        """``n`` bids from each (first event id, key) pair: ``starts``
        int64[m] and ``keys`` [m, 2] give a chunk of [m, n] columns."""
        cfg = self.cfg
        eids = starts[:, None] + torch.arange(n, dtype=torch.int64,
                                              device=starts.device)
        us_per_event = max(1_000_000 // max(cfg.events_per_second, 1), 1)
        ts = cfg.start_time_us + eids * us_per_event
        epoch = eids // TOTAL_PROPORTION
        last_auction = FIRST_AUCTION_ID + epoch * AUCTION_PROPORTION
        last_person = FIRST_PERSON_ID + epoch * PERSON_PROPORTION
        ks = threefry.split(keys, 7)

        def key(j):
            return ks[:, j, :]

        hot = threefry.uniform(key(0), (n,)) < 0.9
        hot_auction = (last_auction // HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO
        cold_auction = last_auction - threefry.randint(
            key(1), (n,), 0, cfg.in_flight_auctions)
        auction = torch.where(hot, hot_auction, cold_auction)
        hot_b = threefry.uniform(key(2), (n,)) < 0.9
        hot_bidder = (last_person // HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO + 1
        cold_bidder = torch.clamp_min(
            last_person - threefry.randint(key(3), (n,), 0,
                                           cfg.active_people),
            FIRST_PERSON_ID)
        bidder = torch.where(hot_b, hot_bidder, cold_bidder)
        price = (100.0 * torch.exp(threefry.uniform(key(4), (n,))
                                   * math.log(1000.0))).to(torch.int64)
        channel = self._channel_ids[threefry.randint(
            key(5), (n,), 0, self._channel_ids.shape[0])]
        url = self._url_ids[threefry.randint(
            key(6), (n,), 0, self._url_ids.shape[0])]
        extra = torch.full_like(channel, self._empty)
        full = torch.ones_like(hot)
        cols = tuple(Column(a, full) for a in (
            auction, bidder, price, channel, url, ts, extra))
        return StreamChunk(torch.zeros_like(channel, dtype=torch.int8),
                           full, cols)   # append-only source

    def _gen_impl(self, start, key: torch.Tensor, k: int) -> StreamChunk:
        """``k`` chunks of bids from ONE key (the reference's batch form):
        [k, chunk_capacity] columns."""
        cap = self.cfg.chunk_capacity
        ch = self._gen_rows(_one_start(start, key.device), key[None],
                            k * cap)
        return map_tensors(ch, lambda a: a.reshape(k, cap))

    def next_batch(self, k: int) -> ChunkBatch:
        """One ChunkBatch of ``k`` full chunks, generated on the device."""
        key = threefry.fold_in(threefry.prng_key(self._seed, self.device),
                               self._batch_no)
        self._batch_no += 1
        start = self.events_so_far
        self.events_so_far += k * self.cfg.chunk_capacity
        return ChunkBatch(self._gen_impl(start, key, k))

    def chunk_fn(self):
        """``(start_event_id, key) -> StreamChunk``: ONE chunk of
        ``chunk_capacity`` bids, as the reference's ``chunk_fn``. It also
        takes a batch — ``start`` int64[k] and ``key`` [k, 2] — and then
        returns the k chunks at once as [k, chunk_capacity] columns, chunk i
        equal to ``fn(start[i], key[i])``; the fused epochs generate a whole
        epoch in that one call."""
        cap = self.cfg.chunk_capacity

        def fn(start, key):
            if key.dim() == 1:
                ch = self._gen_rows(_one_start(start, key.device), key[None],
                                    cap)
                return map_tensors(ch, lambda a: a[0])
            return self._gen_rows(start, key, cap)

        return fn


def _vocab() -> list[str]:
    """The strings of ``GLOBAL_STRING_DICT``, indexed by id."""
    return [GLOBAL_STRING_DICT.lookup(i)
            for i in range(len(GLOBAL_STRING_DICT))]


def _one_start(start, device) -> torch.Tensor:
    """A first event id (Python int or int64 tensor scalar) as int64[1]."""
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), start, dtype=torch.int64, device=device)
