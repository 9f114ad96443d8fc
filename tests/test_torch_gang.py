"""The gang wave (``fleet/gang.py``) against the JAX package's.

K21g's and K24's twins against the JAX gang hooks of GridWalk and
CapCounter, K23's twin against the JAX ``_build_wave`` on a padded batch,
and ``run_gang(device="cpu")`` against the JAX ``run_gang``, JAX's solo
``spawn_tpu`` and the port's solo ``spawn_gpu`` on the gangs of
``tests/test_fleet.py`` and a gang of 5; ``gang_eligibility``'s reasons
against the JAX package's.  JAX's runs are made once per module.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import stateright_tpu.models.fixtures as jfx  # noqa: E402
from stateright_tpu.core.model import Property as JProperty  # noqa: E402
from stateright_tpu.fleet import gang_eligibility as jgang_eligibility  # noqa: E402
from stateright_tpu.fleet import run_gang as jrun_gang  # noqa: E402
from stateright_tpu.fleet.gang import _build_wave as jbuild_wave  # noqa: E402
from stateright_tpu.serve.jobs import JobSpec as JJobSpec  # noqa: E402
from stateright_tpu.serve.portfolio import checker_summary as jchecker_summary  # noqa: E402
from stateright_tpu_torch.core.model import Property  # noqa: E402
from stateright_tpu_torch.fleet import gang as pgang  # noqa: E402
from stateright_tpu_torch.fleet import gang_eligibility, run_gang  # noqa: E402
from stateright_tpu_torch.fleet.gang import gang_eval_plain  # noqa: E402
from stateright_tpu_torch.models.fixtures import (  # noqa: E402
    CapCounter, GridWalk, GridWalkCompiled, cap_counter_gang_plain,
    cap_counter_plain, grid_walk_gang_plain,
)
from stateright_tpu_torch.ops.device_fp import device_fp64_plain  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32, u32  # noqa: E402
from stateright_tpu_torch.serve.jobs import JobSpec  # noqa: E402
from stateright_tpu_torch.serve.portfolio import checker_summary  # noqa: E402

SOLO = dict(capacity=1 << 12, max_frontier=1 << 7)  # tests/test_fleet.py's
GRID_BOUNDS = (3, 5, 6, 8)
CAP_PARAMS = [(4, 10), (12, 8), (6, 6), (9, 20)]
GANG_OF_5 = (2, 3, 5, 6, 8)  # padded to K = 8
RNG = np.random.default_rng(20261018)


def _members(models):
    return [{"tag": i, "model": m, "cm": m.compiled(),
             "consts": m.compiled().gang_constants()}
            for i, m in enumerate(models)]


def _vmap2(fn):
    """``fn(state u32[W], consts u32[C])`` over ``[K, F, W]`` and ``[K, C]``."""
    return jax.jit(jax.vmap(jax.vmap(fn, in_axes=(0, None)), in_axes=(0, 0)))


def _u32(a):
    return jnp.asarray(np.asarray(a, np.uint32))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = to_numpy_u32(got)
    else:
        got = got.numpy()
    np.testing.assert_array_equal(got, want)


# --- K21g, K24: the family kernels' twins against the JAX hooks -----------


def _grid_rows(k, f):
    rows = RNG.integers(0, 2**32, size=(k, f, 1), dtype=np.uint64).astype(np.uint32)
    small = RNG.integers(0, 40, size=(k, f, 2), dtype=np.uint32)
    rows[:, : f // 2, 0] = small[:, : f // 2, 0] | (small[:, : f // 2, 1] << 16)
    rows[:, -4:, 0] = [0xFFFF, 0xFFFF << 16, 0xFFFFFFFF, 4 | (4 << 16)]
    return rows


def test_k21g_twin_matches_jax_gang_hooks():
    """K21g's twin: successors, validity (the box test on each successor)
    and conds of every job under its own bound, bounds 0, 4 and 32,767 and
    words with x or y at 0xFFFF, against the JAX GridWalk gang hooks."""
    bounds = np.array([[0], [4], [32767], [17]], np.uint32)
    rows = _grid_rows(4, 64)
    cm = jfx.GridWalk(bound=0).compiled()

    def one(s, c):
        nexts, valid = cm.gang_step(s, c)
        inside = jax.vmap(lambda r: cm.gang_boundary(r, c))(nexts)
        return nexts, valid & inside, cm.gang_property_conds(s, c)

    want = _vmap2(one)(_u32(rows), _u32(bounds))
    states, consts = from_numpy_u32(rows, "cpu"), from_numpy_u32(bounds, "cpu")
    got = grid_walk_gang_plain(states, consts)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[1].any() and not got[1].all() and got[2][..., 1].any()
    # The port's hooks, each a call into K21g, against the JAX hooks.
    pcm = GridWalk(bound=0).compiled()
    nexts, valid = pcm.gang_step(states, consts)
    _same(nexts, want[0])
    assert bool(valid.all())
    k, f = rows.shape[:2]
    jinside = jax.jit(jax.vmap(jax.vmap(cm.gang_boundary, in_axes=(0, None)),
                               in_axes=(0, 0)))(_u32(rows), _u32(bounds))
    _same(pcm.gang_boundary(states, consts), jinside)
    _same(pcm.gang_property_conds(states, consts), want[2])
    for g, w in zip(pcm.gang_expand(states, consts), want):
        _same(g, w)


CAP_CONSTS = [(0, 0), (0, 2**31 + 5), (2**31, 7), (2**32 - 1, 2**32 - 1),
              (5, 3), (2**31 + 1, 2**31)]


def _cap_rows(f):
    rows = RNG.integers(0, 2**32, size=(f, 1), dtype=np.uint64).astype(np.uint32)
    edge = [0, 1, 2, 3, 4, 5, 6, 7, 2**31 - 1, 2**31, 2**31 + 1, 2**31 + 5,
            2**31 + 6, 2**32 - 2, 2**32 - 1]
    rows[: len(edge), 0] = edge
    return rows


def test_k24_twins_match_jax_solo_and_gang():
    """K24's twins: the solo step and conds against the JAX
    ``CapCounterCompiled.step``/``property_conds``, and the gang entry
    against its gang hooks, with ``limit`` and ``cap`` at 0 and past 2**31
    (unsigned comparisons)."""
    rows = _cap_rows(64)
    for limit, cap in CAP_CONSTS:
        cm = jfx.CapCounter(limit=limit, cap=cap).compiled()
        jnexts, jvalid = jax.vmap(cm.step)(_u32(rows))
        jconds = jax.vmap(cm.property_conds)(_u32(rows))
        got = cap_counter_plain(from_numpy_u32(rows, "cpu"), limit, cap)
        for g, w in zip(got, (jnexts, jvalid, jconds)):
            _same(g, w)
        solo = CapCounter(limit=limit, cap=cap).compiled()
        rows_t = from_numpy_u32(rows, "cpu")
        for plain in (False, True):
            walk = solo.walk_step(rows_t, plain=plain)
            assert all(torch.equal(a, b) for a, b in zip(walk[:3], got))
        assert all(torch.equal(a, b) for a, b in zip(solo.expand(rows_t)[:3], got))
    consts = np.array(CAP_CONSTS, np.uint32)
    k = len(CAP_CONSTS)
    krows = np.stack([rows] * k)
    cm = jfx.CapCounter().compiled()

    def one(s, c):
        nexts, valid = cm.gang_step(s, c)
        return nexts, valid, cm.gang_property_conds(s, c)

    want = _vmap2(one)(_u32(krows), _u32(consts))
    states, consts_t = from_numpy_u32(krows, "cpu"), from_numpy_u32(consts, "cpu")
    got = cap_counter_gang_plain(states, consts_t)
    for g, w in zip(got, want):
        _same(g, w)
    pcm = CapCounter().compiled()
    for g, w in zip(pcm.gang_step(states, consts_t), want[:2]):
        _same(g, w)
    assert pcm.gang_boundary(states, consts_t) is None
    _same(pcm.gang_property_conds(states, consts_t), want[2])
    for g, w in zip(pcm.gang_expand(states, consts_t), want):
        _same(g, w)
    assert got[1].any() and not got[1].all()
    assert got[2][..., 1].any() and not got[2][..., 1].all()


def test_gang_hooks_default_to_not_gang_capable():
    """A compiled model that declares no gang family: ``gang_key`` is None,
    ``gang_boundary`` None (unbounded), and the other hooks raise, as the
    JAX defaults do -- ``gang_expand`` included, which only a family's fused
    gang kernel provides."""
    from stateright_tpu.models.twophase import TwoPhaseSys as JTwoPhaseSys
    from stateright_tpu_torch.models.twophase import TwoPhaseSys

    cm, jcm = TwoPhaseSys(rm_count=3).compiled(), JTwoPhaseSys(rm_count=3).compiled()
    assert cm.gang_key() is None and jcm.gang_key() is None
    states = torch.zeros((1, 2, cm.state_width), dtype=torch.int32)
    consts = torch.zeros((1, 1), dtype=torch.int32)
    assert cm.gang_boundary(states, consts) is None
    for call in (cm.gang_constants, lambda: cm.gang_step(states, consts),
                 lambda: cm.gang_property_conds(states, consts),
                 lambda: cm.gang_expand(states, consts)):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError):
        jcm.gang_constants()


# --- K23: the gang wave's gate and first hits against _build_wave -----------


def test_k23_twin_matches_jax_build_wave():
    """One K = 8 GridWalk wave: K21g's twin, then K23's and K1's, against
    the JAX ``_build_wave`` -- the hit masks reduced to each property's first
    active lane, the gated validity, the generated counts, the successors
    and their fingerprints.  Jobs hit at lane 0, at the last active lane
    and only in their padding; one awaits nothing, one only "in bounds";
    three are padded jobs (zero constants, no active lane) holding rows
    that would hit."""
    K, F, A, W, P = 8, 16, 2, 1, 2
    rows = _grid_rows(K, F)
    consts = np.array([[6], [6], [6], [6], [6], [0], [0], [0]], np.uint32)
    n_active = [F, 9, 5, 12, F, 0, 0, 0]
    active = np.arange(F)[None, :] < np.array(n_active)[:, None]
    corner, outside = 6 | (6 << 16), 7 | (2 << 16)
    rows[:5, :, 0] = np.minimum(rows[:5, :, 0] & 0x0003_0003, corner - 1)
    rows[0, 0, 0] = corner          # SOMETIMES hit at lane 0
    rows[1, 8, 0] = outside         # ALWAYS hit at the last active lane
    rows[2, 5:, 0] = corner         # hits in the padding only
    rows[2, 7, 0] = outside
    rows[5:, :, 0] = 0              # a zero bound's corner, never active
    undisc = np.ones((K, P), bool)
    undisc[3] = False               # nothing awaited: no lane expands
    undisc[4] = [True, False]       # "in bounds" alone awaits
    jcm = jfx.GridWalk(bound=6).compiled()
    wave = jbuild_wave(jcm, ["ALWAYS", "SOMETIMES"], K, F, A, W, P, 1, True)
    hitm, jnexts, jvalid, jgen, jhi, jlo = (np.asarray(x) for x in wave(
        _u32(rows), jnp.asarray(active), _u32(consts), jnp.asarray(undisc)))

    nexts, valid, conds = grid_walk_gang_plain(from_numpy_u32(rows, "cpu"),
                                               from_numpy_u32(consts, "cpu"))
    gated, generated, first = gang_eval_plain(
        conds, valid, torch.from_numpy(active), torch.from_numpy(undisc), 0b01)
    hi, lo = device_fp64_plain(nexts.view(K * F * A, W))
    want_first = np.where(hitm.any(-1), hitm.argmax(-1), -1)
    np.testing.assert_array_equal(first.numpy(), want_first)
    np.testing.assert_array_equal(gated.numpy(), jvalid)
    np.testing.assert_array_equal(generated.numpy(), jgen)
    _same(nexts, jnexts)
    _same(hi.view(K, F * A), jhi)
    _same(lo.view(K, F * A), jlo)
    assert first[0, 1] == 0 and first[1, 0] == 8
    assert (first[2] == -1).all() and (first[5:] == -1).all()
    assert generated[3] == 0 and (generated[5:] == 0).all() and generated[0] > 0


# --- run_gang: the engine against JAX's gang and both packages' solo runs ---


def _jax_solo(model):
    """JAX's solo run's summary and ``discovered_fingerprints()``, the
    latter taken with JAX's ``device_fp64`` jitted: called op by op, as the
    checker calls it, it compiles every op anew for each row count.  The
    function is the same."""
    import stateright_tpu.ops.device_fp as jfp

    c = model.checker().spawn_tpu(**SOLO).join()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfp, "device_fp64", jax.jit(jfp.device_fp64))
        return jchecker_summary(c), c.discovered_fingerprints()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's gangs and solo runs of the module's cases, and its gangs of the
    hazard variants, once."""
    grid = {b: _jax_solo(jfx.GridWalk(bound=b)) for b in (2, 3, 5, 6, 8)}
    cap = [_jax_solo(jfx.CapCounter(limit=lim, cap=c)) for lim, c in CAP_PARAMS]
    gangs = {
        "grid": jrun_gang(_members([jfx.GridWalk(bound=b) for b in GRID_BOUNDS])),
        "cap": jrun_gang(_members([jfx.CapCounter(limit=lim, cap=c)
                                   for lim, c in CAP_PARAMS])),
        "five": jrun_gang(_members([jfx.GridWalk(bound=b) for b in GANG_OF_5])),
        "eject": jrun_gang(_members([jfx.GridWalk(bound=2),
                                     jfx.GridWalk(bound=12)]), max_frontier=8),
    }
    for name, (props_of, conds_fn, inits) in VARIANTS.items():
        jcls = _jax_variant(props_of(JProperty), conds_fn, _variant_key(name),
                            inits)
        gangs[name] = jrun_gang(_members([jcls(bound=b)
                                          for b in VARIANT_BOUNDS]))
    return grid, cap, gangs


@pytest.fixture(scope="module")
def port_solo():
    """The port's solo ``spawn_gpu(device="cpu")`` run of a model, once for
    each model class and constants."""
    runs = {}

    def run(model):
        key = (type(model), tuple(model.compiled().gang_constants()))
        if key not in runs:
            runs[key] = model.checker().spawn_gpu(device="cpu", **SOLO).join()
        return runs[key]

    return run


def _check_gang(ours, theirs, solos, models, port_solo):
    (results, waves), (jresults, jwaves) = ours, theirs
    assert waves == jwaves
    for (tag, c, reason), (jtag, jc, jreason), solo, model in zip(
            results, jresults, solos, models):
        assert (tag, reason) == (jtag, jreason)
        assert c is not None, reason
        summary = checker_summary(c)
        assert summary == jchecker_summary(jc) == solo[0]
        np.testing.assert_array_equal(c.discovered_fingerprints(), solo[1])
        np.testing.assert_array_equal(c.discovered_fingerprints(),
                                      jc.discovered_fingerprints())
        port = port_solo(model)
        assert summary == checker_summary(port)
        np.testing.assert_array_equal(c.discovered_fingerprints(),
                                      port.discovered_fingerprints())
        m = c.metrics()
        assert (m["engine"], m["gang_waves"], m["gang_size"]) == (
            "gang-member", waves, len(results))


@pytest.mark.parametrize("bounds", [GRID_BOUNDS, GANG_OF_5],
                         ids=["four", "five"])
def test_gang_of_grid_walks_matches_jax_and_solo_runs(bounds, jax_side,
                                                    port_solo):
    """The parity gate: each member's summary (counts, depth, verdicts,
    discoveries with their paths) and fingerprints equal the JAX gang's,
    JAX's solo run's and the port's solo run's.  A gang of 5 pads to 8."""
    grid, _cap, gangs = jax_side
    models = [GridWalk(bound=b) for b in bounds]
    ours = run_gang(_members(models), device="cpu")
    theirs = gangs["grid" if bounds == GRID_BOUNDS else "five"]
    _check_gang(ours, theirs, [grid[b] for b in bounds], models, port_solo)
    for (_t, c, _r), b in zip(ours[0], bounds):
        assert c.unique_state_count() == (b + 1) ** 2


def test_gang_mixed_verdicts_match_jax_and_solo_runs(jax_side, port_solo):
    """A violating member reports its own verdict; its gang-mates stay
    clean."""
    _grid, cap, gangs = jax_side
    models = [CapCounter(limit=lim, cap=c) for lim, c in CAP_PARAMS]
    ours = run_gang(_members(models), device="cpu")
    _check_gang(ours, gangs["cap"], cap, models, port_solo)
    assert [checker_summary(c)["violation"] for _, c, _ in ours[0]] == [
        None, "within cap", None, None]


def test_gang_member_overgrowing_geometry_is_ejected(jax_side):
    """A member whose next frontier outgrows F is ejected with JAX's reason;
    its gang-mate runs on to the solo result."""
    grid, _cap, gangs = jax_side
    (small, big), waves = run_gang(
        _members([GridWalk(bound=2), GridWalk(bound=12)]), max_frontier=8,
        device="cpu")
    (jsmall, jbig), jwaves = gangs["eject"]
    assert waves == jwaves
    assert big[1] is None and big[2] == jbig[2] and "frontier" in big[2]
    assert checker_summary(small[1]) == jchecker_summary(jsmall[1]) == grid[2][0]
    assert small[1].unique_state_count() == 9


def test_gang_ejects_on_init_frontier_and_state_budget():
    """The other two ejects, with JAX's reason text: an init frontier wider
    than F, and more than ``max_states`` states."""

    class Wide(GridWalk):
        def init_states(self):
            return [(x, 0) for x in range(3)]

    (wide, ok), _ = run_gang(_members([Wide(bound=4), GridWalk(bound=1)]),
                             max_frontier=2, device="cpu")
    assert wide[2] == "init frontier exceeds gang geometry" and ok[1] is not None
    (big, small), _ = run_gang(_members([GridWalk(bound=9), GridWalk(bound=1)]),
                               max_states=20, device="cpu")
    assert big[2].startswith("state budget overgrown (") and big[2].endswith(" > 20)")
    assert small[1].unique_state_count() == 4


# --- the hazards: seeding order, finish after commit, no properties ---------


def _jax_variant(props, conds_fn, key, inits=None):
    """A JAX GridWalk with other properties (and init states): the model, its
    compiled subclass's ``property_conds``/``gang_property_conds`` from
    ``conds_fn(x, y) -> [cond, ...]`` and a gang key of its own."""

    class Compiled(jfx.GridWalkCompiled):
        def property_conds(self, state):
            w = state[0]
            return jnp.stack(conds_fn(w & 0xFFFF, w >> 16)) if props else \
                jnp.zeros((0,), jnp.bool_)

        def gang_property_conds(self, state, consts):
            return self.property_conds(state)

        def gang_key(self):
            return key

    class Model(jfx.GridWalk):
        def init_states(self):
            return inits or jfx.GridWalk.init_states(self)

        def properties(self):
            return list(props)

        def compiled(self):
            return Compiled(self)

    return Model


def _port_variant(props, conds_fn, key, inits=None):
    class Compiled(GridWalkCompiled):
        def property_conds(self, states):
            w = u32(states[:, 0])
            cols = conds_fn(w & 0xFFFF, w >> 16) if props else []
            return torch.stack(cols, 1) if cols else \
                torch.zeros((states.shape[0], 0), dtype=torch.bool)

        def gang_property_conds(self, states, consts):
            k, f, w = states.shape
            return self.property_conds(states.reshape(k * f, w)).view(k, f, -1)

        def gang_key(self):
            return key

    class Model(GridWalk):
        def init_states(self):
            return inits or GridWalk.init_states(self)

        def properties(self):
            return list(props)

        def compiled(self):
            return Compiled(self)

    return Model


VARIANTS = {
    # several init states, one repeated: seeded in init order, first wins.
    "inits": (lambda m: [
        m.always("y below 9", lambda _m, s: s[1] <= 8),
        m.sometimes("x reaches 2", lambda _m, s: s[0] == 2)],
        lambda x, y: [y <= 8, x == 2],
        [(1, 0), (0, 1), (1, 0), (0, 0)]),
    # every property found: the member finishes after that wave's commit.
    "finish": (lambda m: [m.sometimes("x reaches 2", lambda _m, s: s[0] == 2)],
               lambda x, y: [x == 2], None),
    # no property: nothing is awaited, the frontier empties.
    "none": (lambda m: [], lambda x, y: [], None),
}
VARIANT_BOUNDS = (3, 5)


def _variant_key(name):
    return ("GridWalk-" + name, 1, 2, len(VARIANTS[name][0](Property)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gang_hazards_match_jax_gang_and_port_solo(variant, jax_side,
                                                   port_solo):
    """Seeding in init order over K1's row-order fingerprints; a member
    whose every property is witnessed finishes after the commit (its last
    wave's successors counted, never expanded); a member with no property
    finishes when its frontier empties -- each against the JAX gang and the
    port's solo run."""
    props_of, conds_fn, inits = VARIANTS[variant]
    pcls = _port_variant(props_of(Property), conds_fn, _variant_key(variant),
                         inits)
    jres, jwaves = jax_side[2][variant]
    models = [pcls(bound=b) for b in VARIANT_BOUNDS]
    res, waves = run_gang(_members(models), device="cpu")
    assert waves == jwaves
    for (_t, c, _r), (_jt, jc, _jr), model in zip(res, jres, models):
        ours = checker_summary(c)
        assert ours == jchecker_summary(jc)
        np.testing.assert_array_equal(c.discovered_fingerprints(),
                                      jc.discovered_fingerprints())
        solo = port_solo(model)
        np.testing.assert_array_equal(c.discovered_fingerprints(),
                                      solo.discovered_fingerprints())
        want = checker_summary(solo)
        # Where the JAX gang counts otherwise than a solo run, the port's
        # gang counts as the JAX gang does: a repeated init state once, and
        # the finishing wave's successors into the set but not the depth.
        if variant == "inits":
            want["state_count"] -= 1
        if variant == "finish":
            want["max_depth"] -= 1
        assert ours == want
    if variant == "none":
        assert all(c.unique_state_count() == 1 for _t, c, _r in res)
    if variant == "finish":
        assert all(c.unique_state_count() < (b + 1) ** 2
                   for (_t, c, _r), b in zip(res, VARIANT_BOUNDS))


def test_a_wave_is_one_fixed_set_of_launches(monkeypatch, tmp_path):
    """Each wave calls the family's gang kernel, K23 and K1 once each,
    whatever K is (K1 once more to seed), and the journal gets no event: the
    port builds its kernels once a process and has no compile to record."""
    calls = {"expand": 0, "eval": 0, "fp": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(GridWalkCompiled, "gang_expand",
                        counting("expand", GridWalkCompiled.gang_expand))
    monkeypatch.setattr(pgang, "gang_eval", counting("eval", pgang.gang_eval))
    monkeypatch.setattr(pgang, "device_fp64", counting("fp", pgang.device_fp64))
    journal = tmp_path / "gang.jsonl"
    for bounds in ((4,), (4, 5, 6, 7, 3, 2, 1, 8)):
        for k in calls:
            calls[k] = 0
        seen = []
        _res, waves = run_gang(_members([GridWalk(bound=b) for b in bounds]),
                               journal=str(journal), device="cpu",
                               on_wave=lambda i, tags: seen.append((i, tags)))
        assert calls == {"expand": waves, "eval": waves, "fp": waves + 1}
        assert [i for i, _ in seen] == list(range(1, waves + 1))
    assert not journal.exists()


# --- gang_eligibility --------------------------------------------------------

GRID = {"workload": "grid_walk"}
SPECS = [
    dict(GRID, n=4),
    dict(GRID, n=7),
    dict(GRID, engine="bfs"),
    dict(GRID, target_state_count=10),
    dict(GRID, engine_kwargs={"resume_from": "x"}),
    dict(GRID, engine_kwargs={"capacity": 1 << 10, "max_frontier": 64}),
    {"workload": "fixtures"},
    dict(GRID, symmetry=True),
    dict(GRID, store=True),
    dict(GRID, finish_when="any"),
    dict(GRID, finish_when="all"),
    dict(GRID, target_max_depth=3),
    dict(GRID, timeout=1.0),
    dict(GRID, portfolio={"size": 2}),
    dict(GRID, network="ordered"),
    {"workload": "raft"},
    {"workload": "twophase"},
    {"workload": "nonesuch"},
]


def test_gang_eligibility_reasons_match_jax():
    """``tests/test_fleet.py``'s specs and the other disqualifiers: the
    port's family key and reason equal the JAX package's, its ``tpu``
    engine read as ``gpu``."""
    for spec in SPECS:
        engine = spec.get("engine", "tpu")
        jspec = JJobSpec.from_dict(dict(spec, engine=engine))
        pspec = JobSpec.from_dict(dict(spec, engine="gpu" if engine == "tpu"
                                       else engine))
        got, want = gang_eligibility(pspec), jgang_eligibility(jspec)
        if spec.get("workload") == "nonesuch":  # the registries differ
            assert got[0] is None and want[0] is None
            assert got[1].startswith("build failed: unknown workload 'nonesuch'")
            continue
        assert got == want, spec
    assert gang_eligibility(JobSpec.from_dict(dict(GRID, n=4)))[0] == \
        gang_eligibility(JobSpec.from_dict(dict(GRID, n=7)))[0] is not None


def test_job_spec_and_registry_match_jax():
    """``JobSpec`` round-trips and validates as the JAX one does (engine
    names mapped); the registry serves every ported workload."""
    from stateright_tpu.serve.workloads import build_model as jbuild_model
    from stateright_tpu_torch.ensemble import run_ensemble
    from stateright_tpu_torch.serve.workloads import (
        build_model, cli_spec_for, ensemble_capable, ensemble_winning_seeds,
        workload_label, workload_names,
    )

    spec = JobSpec.from_dict({"workload": "grid_walk", "n": 4})
    assert spec.engine == "gpu" and JobSpec.from_dict(spec.to_dict()).to_dict() \
        == spec.to_dict()
    for bad in ({"workload": "grid_walk", "engine": "tpu"},
                {"workload": "grid_walk", "colour": 1},
                {"workload": "grid_walk", "store": True, "engine": "tiered"}):
        with pytest.raises(ValueError):
            JobSpec.from_dict(bad)
    assert "increment" not in workload_names()
    for name in workload_names():
        model, cli, n = build_model(name)
        jmodel, jcli, jn = jbuild_model(name)
        assert (cli.name, n, cli.default_network, cli.symmetry, cli.gpu,
                cli.gpu_kwargs, cli.target_max_depth, cli.gpu_target_max_depth,
                cli.ensemble) == (
            jcli.name, jn, jcli.default_network, jcli.symmetry, jcli.tpu,
            jcli.tpu_kwargs, jcli.target_max_depth, jcli.tpu_target_max_depth,
            jcli.ensemble), name
        assert [p.name for p in model.properties()] == \
            [p.name for p in jmodel.properties()]
    assert ensemble_capable("abd") and not ensemble_capable("grid_walk")
    assert ensemble_winning_seeds("grid_walk") == []
    sweep = dict(members=16, seed=7, steps=24, fault="skip_ack",
                 chaos='{"default": {"drop": 0.1}}')
    seeds = ensemble_winning_seeds("abd", limit=3, device="cpu", **sweep)
    failing = run_ensemble(shrink=False, replay=False, device="cpu", **sweep).failing
    assert seeds and seeds == [f["seed"] for f in failing[:3]]
    assert cli_spec_for("grid_walk").n_meta == "BOUND"
    assert workload_label("paxos", 3, "ordered", True) == "serve:paxos:3:ordered:sym"
