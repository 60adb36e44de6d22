"""approx_count_distinct's HyperLogLog register lanes in the port against
the reference on the CPU: the register rank ``rho`` at its edge values,
HashAgg and SimpleAgg register lanes bit for bit (read across with
``interop.agg_state_from_jax``) over seeded integer, float (-0.0 and NaN
among them), DECIMAL and VARCHAR arguments, estimates exactly equal, the
checkpoint and recovery of the lanes from the reference's snapshot, the
append-only rule and the exact branch beside a materialized sibling.

VARCHAR registers hash the dictionary id, so both packages get chunks
carrying the same ids (``make_chunk(physical=True)``), as if each had
interned the same strings in the same order. Tolerance: exact (integer
lanes and estimates); the one test whose registers span 53 bits or more
states its bound.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.stream as TS
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu.stream.hash_agg import agg_state_schema as j_agg_schema
from risingwave_tpu.stream.materialized_agg import (
    MaterializedAggExecutor as JMaterializedAggExecutor,
)
from risingwave_tpu_torch import interop
from risingwave_tpu_torch.expr.agg import clz64, hll_estimate, hll_rho
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable
from risingwave_tpu_torch.stream.hash_agg import (
    agg_state_schema as t_agg_schema,
)
from risingwave_tpu_torch.stream.materialized_agg import (
    MaterializedAggExecutor,
)

PKG = {"jax": (J, JE, JS, JStore, JTable, j_agg_schema),
       "torch": (T, TE, TS, TStore, TTable, t_agg_schema)}
I, D = J.OP_INSERT, J.OP_DELETE
CAP = 64

EDGE_W = [0, 1, 2, 3, 2 ** 53 - 1, 2 ** 53, 2 ** 53 + 1, 2 ** 59,
          2 ** 60 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 54 - 1, 2 ** 55 - 1]


@pytest.mark.parametrize("w", EDGE_W)
def test_rho_at_edge_values(w):
    """rho = clz64(w) - 3, exactly: w = 0 gives 61; 2**k - 1 for k >= 54
    (which a float log2 rounds up to 2**k) gives 64 - k - 3."""
    got = int(hll_rho(torch.tensor([w]))[0])
    want = int(jax.lax.clz(jnp.array([w], jnp.int64))[0]) - 3
    assert got == want == 64 - w.bit_length() - 3
    assert int(clz64(torch.tensor([w]))[0]) == 64 - w.bit_length()


def physical_msgs(pkg, schema, epochs, first=1, checkpoint=False):
    """A barrier, then per epoch one chunk of (rows, ops) of physical
    values and a barrier."""
    c, _, s = PKG[pkg][:3]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    out = [s.Barrier.new(first, checkpoint=checkpoint)]
    for i, (rows, ops) in enumerate(epochs):
        out.append(c.make_chunk(schema, rows, ops=ops, capacity=CAP,
                                physical=True, **kw))
        out.append(s.Barrier.new(first + 1 + i, checkpoint=checkpoint))
    return out


def drive(pkg, ex, store=None):
    c, _, s = PKG[pkg][:3]

    async def run():
        out = []
        async for m in ex.execute():
            if isinstance(m, s.Barrier):
                if store is not None and m.checkpoint:
                    store.commit(m.epoch.curr)
            else:
                out.extend(c.chunk_to_rows(m, ex.schema, with_ops=True))
        return out

    with jax.disable_jit():
        return asyncio.run(run())


ARG_KINDS = ("INT64", "FLOAT64", "FLOAT32", "dec2", "VARCHAR", "INT32",
             "BOOL")


def arg_type(c, kind):
    return c.decimal(2) if kind == "dec2" else getattr(c, kind)


def seeded_rows(kind, n, seed):
    """(group, value) rows of physical values: a few groups, ~n/3
    distinct values, NULLs, and for floats -0.0, 0.0 and NaN."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, n)
    if kind in ("FLOAT64", "FLOAT32"):
        pool = np.concatenate([rng.normal(0, 1e3, n // 3),
                               [-0.0, 0.0, np.nan, np.inf]])
        if kind == "FLOAT32":
            pool = pool.astype(np.float32).astype(np.float64)
        v = pool[rng.integers(0, len(pool), n)].tolist()
    elif kind == "BOOL":
        v = (rng.integers(0, 2, n) == 1).tolist()
    elif kind in ("VARCHAR", "INT32"):
        v = rng.integers(0, 40, n).tolist()        # dictionary ids
    else:
        pool = rng.integers(-(2 ** 62), 2 ** 62, n // 3)
        v = pool[rng.integers(0, len(pool), n)].tolist()
    null = rng.random(n) < 0.1
    return [(int(a), None if z else b) for a, b, z in zip(g, v, null)]


def hll_agg(pkg, kind, epochs, store=None, first=1, checkpoint=False):
    c, e, s, _, table_cls, schema_fn = PKG[pkg]
    t = arg_type(c, kind)
    schema = c.Schema.of(("g", c.INT64), ("v", t))
    calls = [e.count_star(), e.agg("approx_count_distinct", 1, t)]
    table = None
    if store is not None:
        table = table_cls(store, 21, schema_fn([schema[0]], calls), [0])
    kw = {"device": "cpu"} if pkg == "torch" else {}
    src = s.MockSource(schema, physical_msgs(pkg, schema, epochs, first,
                                             checkpoint))
    with jax.disable_jit():
        return s.HashAggExecutor(src, [0], calls, state_table=table,
                                 table_capacity=16, out_capacity=16, **kw)


def assert_lanes_equal(jex, tex):
    """Every lane of the reference's agg state, read across through
    ``agg_state_from_jax``, equals the port's slot for slot."""
    host = jax.tree_util.tree_map(np.asarray, jex.state)
    carried = interop.agg_state_from_jax(host, "cpu")
    assert len(carried.lanes) == len(tex.state.lanes) == 1 + 1 + 16
    for a, b in zip(carried.lanes + [carried.table.occupied],
                    tex.state.lanes + [tex.state.table.occupied]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ARG_KINDS)
def test_hash_agg_registers_and_estimates_match_reference(kind):
    """Two epochs of seeded rows, a retraction among them (HLL ignores
    it, in both): lanes bit for bit, output rows (estimates) equal."""
    rows1 = seeded_rows(kind, 48, 1)
    rows2 = seeded_rows(kind, 40, 2)
    epochs = [(rows1, None), (rows2[:30] + rows1[:4],
                              [I] * 30 + [D] * 4)]
    ex = {pkg: hll_agg(pkg, kind, epochs) for pkg in PKG}
    outs = {pkg: drive(pkg, ex[pkg]) for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    assert_lanes_equal(ex["jax"], ex["torch"])
    regs = torch.stack(ex["torch"].state.lanes[2:])
    assert int(regs.max()) > 0


def test_estimates_on_many_distinct_values_equal_reference():
    """tests/test_sql_surface.py's banded test: 37 distinct values per
    group over 400 rows, every estimate equal and within the band."""
    rows = [(i % 2, i % 37) for i in range(400)]
    epochs = [(rows[:CAP], None)] + [(rows[i:i + CAP], None)
                                     for i in range(CAP, 400, CAP)]
    outs = {pkg: drive(pkg, hll_agg(pkg, "INT64", epochs)) for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    final = {}
    for op, (g, n, est) in outs["torch"]:
        if op != J.OP_UPDATE_DELETE:
            final[g] = est
    assert all(22 <= v <= 52 for v in final.values()), final


def test_checkpoint_and_recovery_of_register_lanes():
    """The lanes persist as 16 INT64 columns: equal committed bytes, and
    the port recovered from the reference's snapshot holds the reference's
    recovered lanes and emits what it emits after."""
    first = [(seeded_rows("INT64", 40, 3), None)]
    second = [(seeded_rows("INT64", 30, 4), None)]
    snaps, ex2, outs = {}, {}, {}
    for pkg in PKG:
        store = PKG[pkg][3]()
        drive(pkg, hll_agg(pkg, "INT64", first, store, checkpoint=True),
              store)
        snaps[pkg] = store.snapshot()
        ex2[pkg] = hll_agg(pkg, "INT64", second, store, first=3,
                           checkpoint=True)
    assert snaps["torch"] == snaps["jax"]
    assert_lanes_equal(ex2["jax"], ex2["torch"])
    store = TStore()
    store.restore(snaps["jax"])
    recovered = hll_agg("torch", "INT64", second, store, first=3,
                        checkpoint=True)
    assert_lanes_equal(ex2["jax"], recovered)
    for pkg in PKG:
        outs[pkg] = drive(pkg, ex2[pkg])
    assert drive("torch", recovered) == outs["torch"] == outs["jax"]


def simple_hll(pkg, epochs, stateless=False):
    c, e, s = PKG[pkg][:3]
    schema = c.Schema.of(("k", c.INT64), ("v", c.INT64))
    calls = [e.agg("approx_count_distinct", 1, c.INT64),
             e.agg("approx_count_distinct", 0, c.INT64)]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    src = s.MockSource(schema, physical_msgs(pkg, schema, epochs))
    with jax.disable_jit():
        if stateless:
            return s.StatelessSimpleAggExecutor(src, calls)
        return s.SimpleAggExecutor(src, calls, **kw)


def test_simple_agg_global_and_incremental():
    """tests/test_sql_surface.py::TestApproxCountDistinct::
    test_global_and_incremental as a SimpleAgg: ~1 distinct value, then
    ~101; lanes bit for bit, estimates equal and in the test's bands."""
    epochs = [([(1, 7), (2, 7), (3, 7)], None),
              ([(i, i) for i in range(10, 60)], None),
              ([(i, i) for i in range(60, 110)], None)]
    ex = {pkg: simple_hll(pkg, epochs) for pkg in PKG}
    outs = {pkg: drive(pkg, ex[pkg]) for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    host = jax.tree_util.tree_map(np.asarray, ex["jax"].state)
    carried = interop.simple_agg_state_from_jax(host, "cpu")
    for a, b in zip(carried.lanes, ex["torch"].state.lanes):
        assert torch.equal(a, b)
    # the first barrier emits the empty state's row (an estimate of 0)
    ests = [r[0] for op, r in outs["torch"] if op != J.OP_UPDATE_DELETE]
    assert ests[0] == 0 and 1 <= ests[1] <= 2 and 60 <= ests[-1] <= 160


def test_append_only_rule():
    """The registers are maxima: the stateless (partial) agg rejects the
    call in both packages, and a delete leaves a group's estimate as it
    was (the same in both)."""
    for pkg in PKG:
        with pytest.raises(ValueError, match="stateless"):
            simple_hll(pkg, [([(1, 1)], None)], stateless=True)
    rows = [(0, v) for v in range(20)]
    epochs = [(rows, None), (rows[:10], [D] * 10)]
    outs = {pkg: drive(pkg, hll_agg(pkg, "INT64", epochs)) for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    (op1, (_, n1, e1)), (_, (_, _, e_old)), (_, (_, n2, e2)) = \
        outs["torch"]
    assert (n1, n2) == (20, 10) and e1 == e_old == e2


def test_exact_branch_beside_materialized_sibling():
    """tests/test_materialized_agg.py::
    test_approx_count_distinct_with_materialized_sibling: next to a
    count(DISTINCT) the agg runs on the host tier, where
    approx_count_distinct is the multiset's exact distinct count and
    retracts."""
    outs = {}
    for pkg in PKG:
        c, e, s = PKG[pkg][:3]
        schema = c.Schema.of(("k", c.INT64), ("v", c.INT64),
                             ("s", c.VARCHAR))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        msgs = [s.Barrier.new(1), c.make_chunk(
            schema, [(1, 10, "a"), (1, 10, "b"), (1, 20, "c"), (2, 5, "d")],
            capacity=8, **kw), s.Barrier.new(2),
            c.make_chunk(schema, [(1, 20, "c")], ops=[D], capacity=8, **kw),
            s.Barrier.new(3),
            c.make_chunk(schema, [(2, 6, "e")], capacity=8, **kw),
            s.Barrier.new(4)]
        calls = [e.agg("approx_count_distinct", 1, c.INT64),
                 e.agg("count", 1, c.INT64, distinct=True)]
        cls = (MaterializedAggExecutor if pkg == "torch"
               else JMaterializedAggExecutor)
        outs[pkg] = drive(pkg, cls(s.MockSource(schema, msgs), [0], calls,
                                   out_capacity=8, **kw))
    assert outs["torch"] == outs["jax"]
    final = {}
    for op, r in outs["torch"]:
        if op in (I, J.OP_UPDATE_INSERT):
            final[r[0]] = r
    assert sorted(final.values()) == [(1, 1, 1), (2, 2, 2)]


def test_varchar_registers_follow_dictionary_ids():
    """Finding (ROADMAP C3): a VARCHAR argument's registers hash its
    dictionary id, in both packages, so they equal those of an INT32
    column of the same ids. Ids are process-local: lanes persisted and
    recovered in a process that interned the same strings in another
    order register a string seen again under its new id, and it may
    count twice. The port keeps the reference's rule (its lanes match
    the reference's bit for bit)."""
    rows = [(0, i) for i in range(30)]
    lanes = {}
    for kind in ("VARCHAR", "INT32"):
        ex = hll_agg("torch", kind, [(rows, None)])
        drive("torch", ex)
        lanes[kind] = torch.stack(ex.state.lanes[2:])
    assert torch.equal(lanes["VARCHAR"], lanes["INT32"])
    # the same string under another id lands elsewhere
    one = TE.agg("approx_count_distinct", 0, T.VARCHAR)
    on = torch.tensor([True])
    a = torch.stack(one.hll_contributions(torch.tensor([3], dtype=torch.int32),
                                          on))
    b = torch.stack(one.hll_contributions(torch.tensor([4], dtype=torch.int32),
                                          on))
    assert not torch.equal(a, b)


def test_estimate_bound_when_registers_span_53_bits():
    """Registers spanning 61 bits: the 16 float64 terms no longer sum
    exactly, so the estimate is held to within 1 of the reference's
    (rounding of a sum that may differ in its last bit)."""
    regs = [[61] + [0] * 15, [61] * 8 + [1] * 8, [60, 59] + [2] * 14,
            list(range(1, 17)), [0] * 16, [61] * 16]
    lanes_t = [torch.tensor([r[j] for r in regs]) for j in range(16)]
    got = hll_estimate(lanes_t).tolist()
    call = JE.agg("approx_count_distinct", 0, J.INT64)
    want, _ = call.output([jnp.array([r[j] for r in regs])
                           for j in range(16)], jnp.ones(len(regs), bool))
    assert all(abs(a - int(b)) <= 1 for a, b in zip(got, np.asarray(want)))
    assert got[-1] == 2 ** 63 - 1           # saturated, as the reference
    # below a span of 53 bits the two are equal
    assert got[2:5] == np.asarray(want)[2:5].tolist()
