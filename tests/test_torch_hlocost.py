"""The port's HLO text parsers (``repro_torch.core.hloparse``,
``repro_torch.core.hlocost`` and ``repro_torch.launch.diagnose.walk_costs``)
against the reference's, on HLO text that jax compiles here on one CPU
device: the four programs ``tests/test_hlocost.py`` compiles, the
reference's SMOKE train step of minitron-4b (its layer scan gives while
loops, fusions and calls), and one hand-written module holding every
collective opcode, a ``-start`` / ``-done`` pair and a conditional
(one CPU device compiles no collective).  The port is a text parser
with no jax; it must give exactly the reference's numbers: every
comparison is ``==``.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from repro import configs as rconfigs
from repro.core import hlocost as rcost
from repro.core import hloparse as rparse
from repro.models import model as rmodel
from repro.sharding.rules import ExecConfig as RefExec
from repro.train import optim as ropt
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.core import hlocost as tcost
from repro_torch.core import hloparse as tparse
from repro_torch.launch import diagnose as tdiag


def _compile(f, *args) -> str:
    return jax.jit(f).lower(*args).compile().as_text()


def _scan_matmul() -> str:
    def f(x, ws):
        def body(c, w):
            return jnp.dot(c, w), ()
        c, _ = jax.lax.scan(body, x, ws)
        return c
    return _compile(f, jax.ShapeDtypeStruct((256, 512), jnp.float32),
                    jax.ShapeDtypeStruct((7, 512, 512), jnp.float32))


def _nested_scan() -> str:
    def g(x, ws):
        def outer(c, w):
            def inner(c2, _):
                return jnp.tanh(jnp.dot(c2, w)), ()
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, ()
        c, _ = jax.lax.scan(outer, x, ws)
        return c
    return _compile(g, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                    jax.ShapeDtypeStruct((5, 128, 128), jnp.float32))


def _matmul() -> str:
    a = jax.ShapeDtypeStruct((512, 512), jnp.float32)
    return _compile(lambda a, b: a @ b, a, a)


def _tagged() -> str:
    @jax.named_scope("flash_tile")
    def inner(a):
        return jnp.exp(a) * 2
    return _compile(lambda a: inner(a).sum(),
                    jax.ShapeDtypeStruct((256, 256), jnp.float32))


def _smoke_train_step() -> str:
    cfg = rconfigs.smoke_config("minitron-4b")
    params = jax.eval_shape(lambda k: rmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    ocfg = ropt.AdamWConfig()
    opt = jax.eval_shape(lambda p: ropt.adamw_init(p, ocfg), params)
    tok = jax.ShapeDtypeStruct((2, 32), jnp.int32)
    step = ref_make_train_step(cfg, RefExec(), ocfg)
    return _compile(step, params, opt, {"tokens": tok, "labels": tok})


#: Every collective opcode, async pairs, a while loop whose body holds a
#: collective and a fusion, a conditional, and s4 / bf16 / tuple shapes.
_COLLECTIVES_HLO = """\
HloModule collectives, entry_computation_layout={(f32[8,128]{1,0})->f32[8,128]{1,0}}

%add (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %sum = f32[] add(f32[] %x, f32[] %y)
}

%fused_mul (p0: f32[8,128], p1: f32[8,128]) -> f32[8,128] {
  %p0 = f32[8,128]{1,0} parameter(0)
  %p1 = f32[8,128]{1,0} parameter(1)
  ROOT %m = f32[8,128]{1,0} multiply(f32[8,128]{1,0} %p0, f32[8,128]{1,0} %p1), metadata={op_name="jit(f)/mlp/mul"}
}

%cond (c: (s32[], f32[8,128])) -> pred[] {
  %c = (s32[], f32[8,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[8,128]{1,0}) %c), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

%body (b: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %b = (s32[], f32[8,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[8,128]{1,0}) %b), index=0
  %v = f32[8,128]{1,0} get-tuple-element((s32[], f32[8,128]{1,0}) %b), index=1
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %v), replica_groups={{0,1,2,3}}, to_apply=%add, metadata={op_name="jit(f)/attn/psum"}
  %f = f32[8,128]{1,0} fusion(f32[8,128]{1,0} %ar, f32[8,128]{1,0} %v), kind=kLoop, calls=%fused_mul
  %one = s32[] constant(1)
  %j = s32[] add(s32[] %i, s32[] %one)
  ROOT %t = (s32[], f32[8,128]{1,0}) tuple(s32[] %j, f32[8,128]{1,0} %f)
}

%br0 (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  ROOT %e = f32[8,128]{1,0} exponential(f32[8,128]{1,0} %a)
}

%br1 (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  ROOT %n = f32[8,128]{1,0} negate(f32[8,128]{1,0} %a)
}

ENTRY %main (x: f32[8,128]) -> f32[8,128] {
  %x = f32[8,128]{1,0} parameter(0)
  %ag = f32[32,128]{1,0} all-gather(f32[8,128]{1,0} %x), dimensions={0}, replica_groups={{0,1,2,3}}
  %rs = f32[8,128]{1,0} reduce-scatter(f32[32,128]{1,0} %ag), dimensions={0}, replica_groups={{0,1,2,3}}, to_apply=%add
  %a2a = bf16[8,128]{1,0} all-to-all(bf16[8,128]{1,0} %xb), dimensions={0}
  %cps = (f32[8,128]{1,0}, f32[8,128]{1,0}) collective-permute-start(f32[8,128]{1,0} %rs), source_target_pairs={{0,1},{1,0}}
  %cpd = f32[8,128]{1,0} collective-permute-done((f32[8,128]{1,0}, f32[8,128]{1,0}) %cps)
  %ars = f32[8,128]{1,0} all-reduce-start(f32[8,128]{1,0} %cpd), to_apply=%add
  %ard = f32[8,128]{1,0} all-reduce-done(f32[8,128]{1,0} %ars)
  %q = s4[64,64]{1,0} parameter(1)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,128]{1,0}) tuple(s32[] %zero, f32[8,128]{1,0} %ard)
  %w = (s32[], f32[8,128]{1,0}) while((s32[], f32[8,128]{1,0}) %init), condition=%cond, body=%body
  %out = f32[8,128]{1,0} get-tuple-element((s32[], f32[8,128]{1,0}) %w), index=1
  %p = pred[] parameter(2)
  %c = f32[8,128]{1,0} conditional(pred[] %p, f32[8,128]{1,0} %out, f32[8,128]{1,0} %out), branch_computations={%br0, %br1}
  ROOT %d = f32[8,128]{1,0} dot(f32[8,128]{1,0} %c, f32[128,128]{1,0} %c), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""

TEXTS = {"scan_matmul": _scan_matmul, "nested_scan": _nested_scan,
         "matmul": _matmul, "tagged": _tagged,
         "smoke_train_step": _smoke_train_step,
         "collectives": lambda: _COLLECTIVES_HLO}
_CACHE = {}


@pytest.fixture(params=sorted(TEXTS))
def hlo(request) -> str:
    if request.param not in _CACHE:
        _CACHE[request.param] = TEXTS[request.param]()
    return _CACHE[request.param]


_FIELDS = ("flops", "bytes", "transcendentals", "collective_bytes",
           "collective_counts", "tag_flops", "tag_bytes")


def test_parse_module_equals_reference(hlo):
    want = rcost.parse_module(hlo)
    got = tcost.parse_module(hlo)
    assert isinstance(got, tcost.ModuleCost)
    for field in _FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.total_collective_bytes == want.total_collective_bytes


def test_parse_module_sees_the_work(hlo):
    """The texts are not trivially equal: each has flops, and the
    hand-written one every collective and the while loop's 12 trips."""
    got = tcost.parse_module(hlo)
    assert got.flops > 0
    if "all-to-all" in hlo:
        assert set(got.collective_bytes) == {
            "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "all-reduce"}
        assert got.collective_counts["all-reduce"] == 1 + 12


@pytest.mark.parametrize("fn", ["shape_bytes", "collective_bytes",
                                "total_collective_bytes", "opcode_bytes",
                                "count_ops"])
def test_hloparse_equals_reference(hlo, fn):
    assert getattr(tparse, fn)(hlo) == getattr(rparse, fn)(hlo)


def _ref_walk_costs():
    """The reference's ``launch.diagnose.walk_costs``.  That module sets
    ``XLA_FLAGS`` to 512 host devices when imported; jax's backend is up
    by now (the texts were compiled), and the flag is put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import diagnose
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return diagnose.walk_costs


def test_walk_costs_equals_reference(hlo):
    coll, byte = tdiag.walk_costs(hlo)
    want_coll, want_byte = _ref_walk_costs()(hlo)
    assert coll == want_coll and byte == want_byte
    assert byte
