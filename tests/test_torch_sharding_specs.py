"""Sharding layouts and inputs of the uniform arch stack in the port
(`Model.param_specs` / `cache_specs`, `sharding.specs`,
`data.pipeline.input_specs` and ``batch``) on the CPU, against the JAX
package:

* the spec tree mirrors the port's parameter tree for every arch; each
  layer's spec equals the reference's stacked spec of its pattern entry,
  less the leading cycle axis, full and reduced; resolved against the
  16 × 16 production mesh shape and (2, 4), `param_shardings` and
  `zero1_shardings` equal what the reference's `sanitize_spec` and
  `zero1_spec` make of each leaf, and `zero1_spec` equals the reference's
  on every stacked leaf; every sharded dim divides on the production mesh
  (tests/test_sharding_specs.py's cases);
* `cache_specs` equals the reference's per cache group, with the batch
  over ``data`` and, when it does not divide, the sequence;
* `input_specs` and ``batch(step)`` equal the reference's;
* one train step of mamba2-780m and gemma2-9b against the reference's
  (tests/test_torch_arch_train.py's `step_parity`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.data import pipeline as jpipeline
from repro.models.common import ShardCtx
from repro.models.common import sanitize_spec as jsanitize_spec
from repro.models.transformer import build_model as jbuild_model
from repro.sharding.specs import zero1_spec as jzero1_spec
from repro_torch import tree as tr
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import pipeline
from repro_torch.models.common import P, sanitize_spec
from repro_torch.models.transformer import build_model
from repro_torch.sharding import param_shardings, zero1_shardings, zero1_spec

from test_torch_arch_train import PARITY, step_parity

MESHES = ({"data": 16, "model": 16}, {"data": 2, "model": 4})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeMesh:
    """What the reference's spec helpers read of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _is_spec(x):
    return isinstance(x, JP)


def port_layout(cfg, jtree, unstack):
    """A reference tree (params' abstract shapes or specs) in the port's
    layout: the stacked pattern entries' leaves cut per cycle by
    ``unstack(leaf)`` (the same leaf for every cycle: specs and shapes do
    not differ between cycles), one dict per layer in execution order,
    then the tail; the encoder's stacked layers likewise."""
    def cut(block):
        return jax.tree.map(unstack, block, is_leaf=_is_spec)

    n_cyc = cfg.n_layers // len(cfg.layer_pattern)
    out = {k: v for k, v in jtree.items()
           if k not in ("layers", "tail", "encoder")}
    out["layers"] = ([cut(e) for _ in range(n_cyc)
                      for e in jtree.get("layers", ())]
                     + list(jtree["tail"]))
    if "encoder" in jtree:
        enc = jtree["encoder"]
        out["encoder"] = {
            "layers": [cut(enc["layers"][0])
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": enc["final_norm"]}
    return out


def _reference(cfg):
    """The reference model's spec tree and abstract param shapes."""
    m = jbuild_model(cfg)
    return m.param_specs(), jax.eval_shape(m.init, jax.random.PRNGKey(0))


def _meta(shapes):
    """Reference abstract shapes (port layout) as meta tensors."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)


def _specs_equal(got, want):
    """A port spec tree against a reference spec tree of the same layout,
    leaf for leaf by path."""
    want_leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=_is_spec)[0]
    got_leaves = list(tr.leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (jpath, w) in zip(got_leaves, want_leaves):
        assert isinstance(g, P), path
        assert tuple(g) == tuple(w), (tr.path_key(path), g, w)


@pytest.mark.parametrize("aid", sorted(ARCH_IDS))
def test_param_specs_mirror_params(aid):
    """The port's spec tree has the port's parameter tree's structure, and
    no spec is longer than its leaf's rank."""
    cfg = reduced(get_arch(aid))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    specs = model.param_specs()
    got = list(tr.leaves_with_path(specs))
    want = list(tr.leaves_with_path(params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, spec), (_, leaf) in zip(got, want):
        assert len(spec) <= leaf.ndim, (tr.path_key(path), spec, leaf.shape)


@pytest.mark.parametrize("aid", sorted(ARCH_IDS))
def test_param_specs_and_shardings_match_reference(aid):
    """Full and reduced configs: the spec tree equals the reference's (each
    layer its pattern entry's stacked spec less the cycle axis), and on
    each mesh shape the sanitized and ZeRO-1 trees equal what the
    reference's functions make of each (unstacked) leaf; `zero1_spec`
    equals the reference's on every stacked leaf too."""
    for jcfg, tcfg in ((jget_arch(aid), get_arch(aid)),
                       (jreduced(jget_arch(aid)), reduced(get_arch(aid)))):
        jspecs, jshapes = _reference(jcfg)
        model = build_model(tcfg, device="cpu")
        specs = model.param_specs()
        lead = lambda s: JP(*tuple(s)[1:]) if _is_spec(s) else \
            jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
        want_specs = port_layout(tcfg, jspecs, lead)
        want_shapes = port_layout(tcfg, jshapes, lead)
        _specs_equal(specs, want_specs)
        meta = _meta(want_shapes)
        for ms in MESHES:
            fake = FakeMesh(ms)
            san = jax.tree.map(
                lambda sp, sh: jsanitize_spec(ms, sh.shape, sp),
                want_specs, want_shapes, is_leaf=_is_spec)
            _specs_equal(param_shardings(ms, specs, meta), san)
            z1 = jax.tree.map(
                lambda sp, sh: jzero1_spec(fake, sp, sh.shape),
                san, want_shapes, is_leaf=_is_spec)
            _specs_equal(zero1_shardings(ms, specs, meta), z1)
            for sp, sh in zip(jax.tree.leaves(jspecs, is_leaf=_is_spec),
                              jax.tree.leaves(jshapes)):
                s = jsanitize_spec(ms, sh.shape, sp)
                assert tuple(zero1_spec(ms, P(*s), sh.shape)) == \
                    tuple(jzero1_spec(fake, s, sh.shape))


def test_full_arch_specs_divisible_on_production_mesh():
    """Full configs on the 16 × 16 mesh: after sanitizing, every sharded dim
    divides its axes' size, something is sharded, and the embedding stays
    vocab-sharded (the padded vocab)."""
    ms = MESHES[0]
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        _, jshapes = _reference(jget_arch(aid))
        meta = _meta(port_layout(
            cfg, jshapes, lambda s: jax.ShapeDtypeStruct(s.shape[1:],
                                                         s.dtype)))
        specs = param_shardings(ms, build_model(cfg, device="cpu")
                                .param_specs(), meta)
        n_sharded = 0
        for spec, leaf in zip(tr.leaves(specs), tr.leaves(meta)):
            for d, names in enumerate(spec):
                if names is None:
                    continue
                n_sharded += 1
                size = 1
                for n in (names if isinstance(names, tuple) else (names,)):
                    size *= ms[n]
                assert leaf.shape[d] % size == 0
        assert n_sharded > 0, aid
        assert tuple(specs["embed"])[0] is not None, aid


def test_zero1_adds_data_axis():
    ms = MESHES[0]
    assert tuple(zero1_spec(ms, P(None, "model"), (4096, 1024)))[0] == "data"
    # never steals a TP axis
    assert tuple(zero1_spec(ms, P("model", None), (16, 7))) == ("model", None)
    # several data axes shard together; a replicated mesh changes nothing
    assert tuple(zero1_spec({"pod": 2, "data": 4, "model": 2},
                            P(None, "model"), (64, 8),
                            dp_axes=("pod", "data"))) == \
        (("pod", "data"), "model")
    assert zero1_spec({"data": 1, "model": 4}, P("model"), (8,)) == \
        P("model")


def test_sanitize_spec_matches_reference():
    rng = np.random.default_rng(0)
    ms = {"data": 2, "model": 4, "pod": 3}
    names = (None, "data", "model", "pod", ("data", "model"),
             ("pod", "data"))
    for _ in range(200):
        rank = int(rng.integers(1, 4))
        shape = tuple(int(x) for x in rng.integers(1, 25, rank))
        entries = tuple(names[int(i)] for i in
                        rng.integers(0, len(names), int(rng.integers(0, 4))))
        entries = entries[:rank]
        assert tuple(sanitize_spec(ms, shape, P(*entries))) == \
            tuple(jsanitize_spec(ms, shape, JP(*entries)))


@pytest.mark.parametrize("aid", ("qwen2-7b", "mamba2-780m", "whisper-small",
                                 "recurrentgemma-9b", "gemma2-9b"))
@pytest.mark.parametrize("batch", (2, 3))
def test_cache_specs_match_reference(aid, batch):
    """Each cache group's spec (one leaf, its layers stacked) equals the
    reference's for that group on a (2, 4) mesh shape: the batch over
    ``data`` when it divides (2), else (3) K/V's sequence over ``data``
    and ``model``; replicated without a mesh."""
    ms = MESHES[1]
    jcfg, tcfg = jreduced(jget_arch(aid)), reduced(get_arch(aid))
    jm = jbuild_model(jcfg, ShardCtx(mesh=FakeMesh(ms)))
    jcache = jax.eval_shape(lambda: jm.init_cache(batch, 32, jnp.bfloat16))
    jspecs = jm.cache_specs(jcache)
    model = build_model(tcfg, device="cpu")
    cache = model.init_cache(batch, 32, torch.bfloat16)
    specs = model.cache_specs(cache, ms)
    assert set(specs) == set(cache)
    one = len(tcfg.layer_pattern) == 1
    for name, spec in specs.items():
        base, _, group = name.partition(".")
        if group.startswith("t"):
            want = (None,) + tuple(jspecs["tail"][int(group[1:])][base])
        else:
            entry = jspecs["layers"][0 if one else int(group)]
            want = tuple(entry[base])
        assert tuple(spec) == want, (name, spec, want)
    assert all(s == P() for s in model.cache_specs(cache).values())


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("aid", ("qwen2-7b", "whisper-small"))
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_input_specs_match_reference(aid, kind):
    jcfg, tcfg = jreduced(jget_arch(aid)), reduced(get_arch(aid))
    want = jpipeline.input_specs(jcfg, JShapeSpec("s", 24, 4, kind))
    got = pipeline.input_specs(tcfg, ShapeSpec("s", 24, 4, kind))
    assert list(got) == list(want)
    for name, spec in got.items():
        assert spec.shape == want[name].shape, name
        assert str(spec.dtype) == f"torch.{want[name].dtype}", name
        assert spec.spec is None
    mesh = _jax_mesh()
    want = jpipeline.input_specs(jcfg, JShapeSpec("s", 24, 4, kind), mesh)
    got = pipeline.input_specs(tcfg, ShapeSpec("s", 24, 4, kind),
                               dict(mesh.shape))
    for name, spec in got.items():
        sharding = want[name].sharding
        want_spec = None if sharding is None else tuple(sharding.spec)
        assert (spec.spec and tuple(spec.spec)) == want_spec, name


def test_batches_equal_reference():
    """``batch(step)`` is the reference's stream, bit for bit, as int32
    tensors on the asked device; iterating yields steps 0, 1, ..."""
    dc = dict(vocab_size=512, seq_len=24, global_batch=3, seed=7)
    jpipe = jpipeline.SyntheticLMPipeline(jpipeline.DataConfig(**dc))
    pipe = pipeline.SyntheticLMPipeline(pipeline.DataConfig(**dc),
                                        device="cpu")
    it = iter(pipe)
    for step in range(3):
        got, want = pipe.batch(step), jpipe.batch(step)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in got:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        nxt = next(it)
        assert all(torch.equal(nxt[k], got[k]) for k in got)


@pytest.mark.parametrize("aid", PARITY["test_torch_sharding_specs"])
def test_train_step_matches_reference(aid):
    step_parity(aid)
