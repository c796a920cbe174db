"""The port's distribution specs, gradient compression and Hessian
reduction (``repro_torch/dist``, ``core/hessian.py``) against the JAX
package, on the CPU and without ranks.

The spec functions read only axis names and sizes, so a ``MeshShape``
stands for the 16 × 16 production mesh, as JAX's tests lay it out over
repeated fake devices.  The port's param and cache trees are built on the
``meta`` device (the port's ``eval_shape``); JAX's come from
``eval_shape``.  Every spec equals JAX's exactly (``P`` compares equal to
the tuple of a JAX ``PartitionSpec``); ``compress_grads`` and
``decompress_grads`` equal JAX's bit for bit over 8 error-feedback steps,
from fp32 and from bf16 gradients; ``combine`` and the one-rank
``all_reduce`` equal JAX's in the stacked and the unstacked form.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.hessian import HessianAccumulator as JAcc  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.dist import sharding as JD  # noqa: E402
from repro.dist.prune import row_partition as j_row_partition  # noqa: E402
from repro.launch.steps import abstract_params  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.hessian import HessianAccumulator  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.dist import sharding as D  # noqa: E402
from repro_torch.dist.prune import row_partition  # noqa: E402
from repro_torch.dist.sharding import P, MeshShape  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402

NAMES = ("data", "model")


def j_mesh(data: int, model: int) -> Mesh:
    """JAX's spec-only mesh over repeated fake devices."""
    devs = np.array(jax.devices() * (data * model))[: data * model]
    return Mesh(devs.reshape(data, model), NAMES)


def meta_model(arch: str):
    """The port's full-config model and its param tree on ``meta``."""
    model = build_model(get_config(arch), device="cpu")
    model.device = torch.device("meta")
    params = model.init(torch.Generator())
    return model, params


def port_flat(tree) -> dict:
    """{path names: leaf} of a port tree (dicts, dataclasses, tuples)."""
    out: dict = {}
    D.map_with_path(lambda path, x: out.setdefault(
        tuple(D._path_names(path)), x), tree)
    return out


def j_flat(tree, is_leaf=None) -> dict:
    return {tuple(JD._path_names(kp)): x for kp, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def is_jp(x) -> bool:
    return isinstance(x, JP)


def sorted_leaves(tree) -> list:
    """Leaves in JAX's order: dict keys sorted, dataclass fields in order,
    non-array fields (a cache's static ``window``) left out."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (isinstance(k, str), k))
        return [x for k in keys for x in sorted_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return [x for v in tree for x in sorted_leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__
                for x in sorted_leaves(getattr(tree, f))]
    return [tree] if isinstance(tree, (torch.Tensor, P)) else []


# ------------------------------------------------------------ param specs
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_fsdp_pspecs_equal_jax_full_config(arch):
    """Both layouts of every FULL config at 16 × 16, path by path."""
    ja = abstract_params(j_build(j_get_config(arch)))
    _, tp_params = meta_model(arch)
    flat = port_flat(tp_params)
    assert all(x.device.type == "meta" for x in flat.values())
    jflat = j_flat(ja)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in jflat.items()}
    jm, mesh = j_mesh(16, 16), MeshShape(NAMES, (16, 16))
    for jfn, fn in ((JD.param_pspecs, D.param_pspecs),
                    (JD.fsdp_pspecs, D.fsdp_pspecs)):
        want = j_flat(jfn(ja, jm), is_leaf=is_jp)
        got = port_flat_specs(fn(tp_params, mesh))
        assert got.keys() == want.keys()
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        assert not bad, (arch, fn.__name__, list(bad.items())[:4])
        assert all(isinstance(s, P) for s in got.values())


def port_flat_specs(tree) -> dict:
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            out[path] = node

    walk(tree, ())
    return out


def test_row_col_parallel_rules_and_whisper_vocab():
    _, a = meta_model("tinyllama-1.1b")
    mesh = MeshShape(NAMES, (16, 16))
    specs = D.param_pspecs(a, mesh)
    blk = specs["blocks"][0]
    assert blk["attn"]["wq"]["w"] == P(None, "model")
    assert blk["attn"]["wo"]["w"] == P("model", None)
    assert blk["mlp"]["down"]["w"] == P("model", None)
    assert specs["embed"]["table"] == P("model", None)
    assert specs["final_norm"]["scale"] == P() == ()
    assert D.fsdp_pspecs(a, mesh)["blocks"][0]["attn"]["wq"]["w"] == \
        P("data", "model") == JP("data", "model")
    _, w = meta_model("whisper-medium")
    assert D.param_pspecs(w, mesh)["embed"]["table"] == P()
    assert repr(P("data", None)) == "P('data', None)"


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_pspecs_fallback_4x4_equal_jax():
    """tests/test_dist_layer.py's 4 × 4 replication fallbacks, against
    JAX's own specs of the same shapes."""
    shapes = {"blocks": {0: {"attn": {"wq": {"w": (48, 96)},
                                      "wo": {"w": (96, 48)}},
                             "mlp": {"down": {"w": (6, 10)}},
                             "ln1": {"scale": (48,)}}},
              "embed": {"table": (50257, 64)}}

    def build(mk, tree):
        return ({k: build(mk, v) for k, v in tree.items()}
                if isinstance(tree, dict) else mk(*tree))

    a, ja = build(_meta, shapes), build(_sds, shapes)
    mesh, jm = MeshShape(NAMES, (4, 4)), j_mesh(4, 4)
    for fn, jfn in ((D.param_pspecs, JD.param_pspecs),
                    (D.fsdp_pspecs, JD.fsdp_pspecs)):
        got = port_flat_specs(fn(a, mesh))
        want = j_flat(jfn(ja, jm), is_leaf=is_jp)
        assert got == want
    fs = D.fsdp_pspecs(a, mesh)
    assert fs["embed"]["table"] == P(None, "data")
    assert fs["blocks"][0]["mlp"]["down"]["w"] == P()
    assert fs["blocks"][0]["ln1"]["scale"] == P("data")


def test_batch_pspecs_and_spec_fallback_equal_jax():
    mesh, jm = MeshShape(NAMES, (4, 4)), j_mesh(4, 4)
    specs = D.batch_pspecs({"tokens": _meta(8, 32), "odd": _meta(3, 5)},
                           mesh)
    jspecs = JD.batch_pspecs({"tokens": _sds(8, 32), "odd": _sds(3, 5)}, jm)
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    assert specs["tokens"] == P("data", None) and specs["odd"] == P()
    for b, r in ((8, 3), (3, 3), (16, 1), (4, 4)):
        assert D.batch_spec(mesh, b, rank=r) == JD.batch_spec(jm, b, rank=r)
    pod = MeshShape(("pod", "data", "model"), (2, 4, 2))
    jpod = Mesh(np.array(jax.devices() * 16)[:16].reshape(2, 4, 2),
                ("pod", "data", "model"))
    assert D.batch_spec(pod, 16, 2) == JD.batch_spec(jpod, 16, 2) == \
        P(("pod", "data"), None)
    assert D.data_axes(pod) == JD.data_axes(jpod) == ("pod", "data")


CACHE_B, CACHE_L = 16, 4096


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_jax_full_config(arch):
    """Every arch's FULL-config cache at 16 × 16, leaf for leaf in JAX's
    order: KV heads over 'model' where they divide it, else the sequence
    (the flash-decoding fallback)."""
    jmodel = j_build(j_get_config(arch))
    jc = jax.eval_shape(lambda: jmodel.init_cache(CACHE_B, CACHE_L))
    model, _ = meta_model(arch)
    cache = model.init_cache(CACHE_B, CACHE_L)
    leaves = sorted_leaves(cache)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    mesh, jm = MeshShape(NAMES, (16, 16)), j_mesh(16, 16)
    got = sorted_leaves(D.cache_pspecs(cache, mesh, CACHE_B))
    want = jax.tree.leaves(JD.cache_pspecs(jc, jm, CACHE_B), is_leaf=is_jp)
    assert got == [tuple(s) for s in want]


def test_cache_pspecs_flash_decoding_fallback():
    model, _ = meta_model("mistral-large-123b")
    specs = D.cache_pspecs(model.init_cache(128, 32768),
                           MeshShape(NAMES, (16, 16)), 128)
    assert specs[0].k[1] == "model" and specs[0].k[2] is None


def test_row_partition_fallback_order_equal_jax():
    """tests/test_dist_layer.py's table, on 4 × 2 and 3 × 1."""
    m42, jm42 = MeshShape(NAMES, (4, 2)), j_mesh(4, 2)
    table = {16: ("data", "model"), 12: ("data",), 6: ("model",), 9: ()}
    for c, want in table.items():
        assert row_partition(c, m42) == j_row_partition(c, jm42) == want
    m31, jm31 = MeshShape(NAMES, (3, 1)), j_mesh(3, 1)
    for c, want in {9: ("data", "model"), 7: ("model",)}.items():
        assert row_partition(c, m31) == j_row_partition(c, jm31) == want


# ------------------------------------------------------ grad compression
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_bitwise_jax_over_8_steps(dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (64,), "b": (8,), "m": (16, 33)}
    jg = {k: jnp.asarray(rng.normal(size=s), jnp.float32).astype(dtype)
          for k, s in shapes.items()}
    g = {k: t(np.asarray(v)) for k, v in jg.items()}
    assert all(g[k].dtype == getattr(torch, dtype) for k in g)
    jef, ef = JC.ErrorFeedback.init(jg), C.ErrorFeedback.init(g)
    total = {k: 0.0 for k in g}
    for _ in range(8):
        jpay, jef = JC.compress_grads(jg, jef)
        pay, ef = C.compress_grads(g, ef)
        jdeq, deq = JC.decompress_grads(jpay), C.decompress_grads(pay)
        for k in g:
            q, s = pay[k]
            # int8 payload: a quarter of the fp32 gradient's bytes
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert q.shape == g[k].shape
            assert np.array_equal(n(q), np.asarray(jpay[k][0]))
            assert n(s).tobytes() == np.asarray(jpay[k][1]).tobytes()
            assert n(ef.residual[k]).tobytes() == \
                np.asarray(jef.residual[k]).tobytes()
            assert n(deq[k]).tobytes() == np.asarray(jdeq[k]).tobytes()
            total[k] = total[k] + n(deq[k])
    for k in g:      # test_dist_layer's error-feedback contract
        ref = n(g[k].float())
        np.testing.assert_allclose(total[k] / 8, ref, atol=2e-2)
        scale = float(np.abs(ref).max()) / 127.0
        assert float(np.abs(n(ef.residual[k])).max()) <= 4 * scale + 1e-6


# ------------------------------------------------------ Hessian reduction
def test_hessian_combine_and_all_reduce_equal_jax():
    """test_dist_layer's reduction hook: combine of the partials equals the
    monolithic accumulator; the one-rank all_reduce passes an unstacked
    accumulator through and sums a stacked one; a leading axis that is not
    the replica count is refused.  Against JAX's on the same inputs."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(32, 16)).astype(np.float32) for _ in range(4)]
    mesh, jm = MeshShape(NAMES, (1, 1)), j_mesh(1, 1)

    parts = [HessianAccumulator.init(16).update(t(x)) for x in xs]
    jparts = [JAcc.init(16).update(jnp.asarray(x)) for x in xs]
    mono = HessianAccumulator.init(16)
    for x in xs:
        mono.update(t(x))
    combined = HessianAccumulator.combine(*parts)
    jcombined = JAcc.combine(*jparts)
    reduced = combined.all_reduce(mesh, ("data",))
    assert reduced is combined                       # one rank: unchanged
    jreduced = jcombined.all_reduce(jm, ("data",))
    np.testing.assert_allclose(n(reduced.finalize()), n(mono.finalize()),
                               rtol=1e-6)
    np.testing.assert_allclose(n(reduced.xtx), np.asarray(jreduced.xtx),
                               rtol=1e-5, atol=1e-4)
    assert float(reduced.count) == float(jreduced.count) == 128.0
    # combine is a plain left-to-right sum: bitwise the same adds
    want = parts[0].xtx + parts[1].xtx + parts[2].xtx + parts[3].xtx
    assert torch.equal(combined.xtx, want)

    stacked = HessianAccumulator(parts[0].xtx[None], parts[0].count[None],
                                 parts[0].skipped[None])
    out = stacked.all_reduce(mesh, ("data",))
    jst = jax.tree.map(lambda x: x[None], jparts[0])
    jout = jst.all_reduce(jm, ("data",))
    assert torch.equal(out.xtx, parts[0].xtx)
    np.testing.assert_array_equal(np.asarray(jout.xtx),
                                  np.asarray(jparts[0].xtx))
    bad = HessianAccumulator(*(torch.stack(v) for v in zip(
        *((p.xtx, p.count, p.skipped) for p in parts))))
    with pytest.raises(ValueError, match="replica axis"):
        bad.all_reduce(mesh, ("data",))
