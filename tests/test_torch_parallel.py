"""Tensor-parallel sharding of the port (`parallel.mesh`, the backbones under
`tp`) against the JAX package's `f5tts_tpu.parallel.mesh` on the CPU.

- The port's `dit_param_specs` equal JAX's leaf by leaf (the JAX depth axis
  of stacked blocks dropped, `w_i8` transposed: the port stores it [n, k])
  for the DiT, the fused int8 serving tree, the MMDiT and the UNetT.
- The ranks' shards concatenated along their specs rebuild each tree (the
  fused to_qkv a third at a time: rank r holds the same heads of q, k, v).
- One spawn of two gloo processes (`tests/torch_dist_jobs.py`) runs 1 x 2
  forwards of a small DiT, UNetT and MMDiT (dim 128, 4 x 32 heads, f32),
  of the DiT with `pe_attn_head=1` (RoPE on global head 0, rank 0's first
  local head) and of the fused int8 DiT. The f32 forwards equal the JAX
  single-device XLA forward within rel-L2 1e-5 on live rows. The int8
  forward takes each row-parallel input's scale over the whole row (an
  all-reduced max): its quantized tree equals the shards of the
  single-device one bit for bit, and its output the single-device port
  int8 forward's within rel-L2 1e-5 (JAX's int8 forward differs from the
  port's by code flips at .5 steps, rel-L2 ~1e-3: tests/test_torch_quant.py,
  so that comparison keeps its 3e-3 gate there and here).
- `flash_attention_sharded` (this rank's rows and heads) against the JAX
  `flash_attention_sharded` on an 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5tts_tpu.config import ModelArch as JArch
from f5tts_tpu.models import dit as jdit
from f5tts_tpu.models import mmdit as jmmdit
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as junett
from f5tts_tpu.ops import quant as jq
from f5tts_tpu.parallel import mesh as jmesh
from f5tts_tpu_torch.config import ModelArch
from f5tts_tpu_torch.convert import (dit_params_from_jax, mmdit_params_from_jax,
                                     unett_params_from_jax)
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models.cfm import BACKBONES
from f5tts_tpu_torch.ops import attention as tattn
from f5tts_tpu_torch.ops import quant as tq
from f5tts_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_dit import _live, jx, np_params
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.torch_dist_jobs import spawn

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = dict(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, text_dim=64, conv_layers=1,
            text_num_embeds=32, mel_dim=16)
UNETT = dict(ARCH, depth=4, text_dim=None, conv_layers=0)
MMDIT = dict(ARCH, text_dim=None, conv_layers=0, text_mask_padding=True)
LENGTHS = [64, 41, 64, 17]
REL = 1e-5
INT8_JAX_GATE = 3e-3  # tests/test_torch_quant.py's forward gate (code flips)


def _rel_live(a, b, lengths=LENGTHS) -> float:
    a, b = _live(np.asarray(a), lengths), _live(np.asarray(b), lengths)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs():
    rng = np.random.default_rng(5)
    b, n = 4, 64
    return {"x": rng.standard_normal((b, n, 16)).astype(np.float32),
            "cond": rng.standard_normal((b, n, 16)).astype(np.float32),
            "text": rng.integers(0, 30, (b, 12)).astype(np.int32),
            "time": rng.uniform(0, 1, (b,)).astype(np.float32),
            "lengths": np.asarray(LENGTHS, np.int32)}


def _jax_trees():
    """name -> (JAX module, JAX arch, numpy JAX params, port params, backbone)."""
    out = {}
    for name, mod, init, arch, conv, backbone in (
            ("dit", jdit, jdit.init_dit, ARCH, dit_params_from_jax, "DiT"),
            ("dit_pe1", jdit, jdit.init_dit, dict(ARCH, pe_attn_head=1), dit_params_from_jax,
             "DiT"),
            ("unett", junett, junett.init_unett, UNETT, unett_params_from_jax, "UNetT"),
            ("mmdit", jmmdit, jmmdit.init_mmdit, MMDIT, mmdit_params_from_jax, "MMDiT")):
        jarch = JArch(**arch)
        tree = np_params(lambda: init(jax.random.PRNGKey(0), jarch), 23)
        out[name] = (mod, jarch, tree, conv(tree), backbone, arch)
    return out


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    """The two processes' forwards (one spawn for the whole file)."""
    cases = {name: {"backbone": t[4], "arch": t[5], "params": tm.fuse_backbone_qkv(t[3])}
             for name, t in trees.items()}
    cases["dit_int8"] = dict(cases["dit"], params=tq.quantize_dit_params(cases["dit"]["params"]))
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    return spawn("tp_forwards", 2, tmp_path_factory.mktemp("tp"),
                 {"cases": cases, "inputs": inputs})


def _jax_forward(mod, jarch, jparams, fwd_name):
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    statics = getattr(mod, {"dit": "DiTStatics", "unett": "UNetTStatics",
                            "mmdit": "MMDiTStatics"}[fwd_name])(jarch)
    fwd = getattr(mod, f"{fwd_name}_forward")
    return np.asarray(fwd(jparams, statics, inp["x"], inp["cond"], inp["text"], inp["time"],
                          lengths=inp["lengths"], backend="xla"))


def _port_spec_matches_jax(port_specs, jax_specs, tree_name: str) -> int:
    """Every port leaf spec against the JAX one at the same dict path; the
    count of leaves compared."""
    count = 0

    def walk(node, jnode, names, stacked):
        nonlocal count
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, jnode[key], names + (key,), stacked)
        elif isinstance(node, list):  # a JAX list, or one stacked dict for all
            for i, sub in enumerate(node):
                walk(sub, jnode[i] if isinstance(jnode, list) else jnode, names,
                     stacked or not isinstance(jnode, list))
        else:
            want = tuple(jnode)[1:] if stacked else tuple(jnode)
            want = want + (None,) * (len(node.axes) - len(want))
            if names[-1] == "w_i8":  # [n, k] here, [k, n] in JAX
                want = want[::-1]
            assert node.axes == want, (tree_name, names, node.axes, want)
            count += 1

    walk(port_specs, jax_specs, (), False)
    return count


@pytest.mark.parametrize("name", ["dit", "dit_int8", "mmdit", "unett"])
def test_param_specs_match_jax(trees, name):
    key = name.replace("_int8", "")
    mod, jarch, tree, tparams, _, _ = trees[key]
    jtree = jx(tree)
    tparams = tm.fuse_backbone_qkv(tparams) if name == "dit_int8" else tparams
    if name == "dit_int8":  # the serving tree: fused to_qkv, int8 leaves
        jtree = jq.quantize_dit_params(jm.fuse_backbone_qkv(jtree))
        tparams = tq.quantize_dit_params(tparams)
    specs = pmesh.dit_param_specs(tparams)
    n = _port_spec_matches_jax(specs, jmesh.dit_param_specs(jtree), name)
    assert n == len(tm.tree_leaves(tparams))
    sharded = [s for s in pmesh._spec_leaves(specs) if s.axis is not None]
    assert len(sharded) >= 8 * (2 if name != "unett" else 4) // 2
    if name == "dit_int8":
        attn = specs["blocks"][0]["attn"]
        assert attn["to_qkv"]["w_i8"] == pmesh.Spec(("model", None), fused=True)
        assert attn["to_out"]["w_scale"].axis is None and attn["to_out"]["b"].axis is None


@pytest.mark.parametrize("name", ["dit", "dit_int8", "mmdit", "unett"])
def test_shards_rebuild_the_tree(trees, name):
    """Rank 0's and rank 1's shards concatenated along each spec give the
    tree back; a fused leaf's third r holds rank r's heads of q, k and v."""
    params = tm.fuse_backbone_qkv(trees[name.replace("_int8", "")][3])
    if name == "dit_int8":
        params = tq.quantize_dit_params(params)
    specs = pmesh.dit_param_specs(params)
    shards = [pmesh.shard_params(params, pmesh.Mesh(1, 2, r)) for r in range(2)]
    for whole, spec, a, b in zip(tm.tree_leaves(params), pmesh._spec_leaves(specs),
                                 tm.tree_leaves(shards[0]), tm.tree_leaves(shards[1])):
        if spec.axis is None:
            assert torch.equal(a, whole) and torch.equal(b, whole)
            continue
        ax = spec.axis
        if spec.fused:
            parts = [torch.cat([x.chunk(3, ax)[i] for x in (a, b)], ax) for i in range(3)]
            assert torch.equal(torch.cat(parts, ax), whole)
            q_heads = whole.chunk(3, ax)[0].chunk(2, ax)
            assert torch.equal(a.chunk(3, ax)[0], q_heads[0])
        else:
            assert torch.equal(torch.cat([a, b], ax), whole)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_params(params, pmesh.Mesh(1, 3, 0))


@pytest.mark.parametrize("name", ["dit", "dit_pe1", "unett", "mmdit"])
def test_tp2_forward_matches_jax_single_device(trees, ranks, name):
    mod, jarch, tree, _, _, _ = trees[name]
    want = _jax_forward(mod, jarch, jx(tree), {"dit_pe1": "dit"}.get(name, name))
    for out in ranks:
        assert _rel_live(out[name].numpy(), want) <= REL, name


def test_tp2_fused_int8_forward(trees, ranks):
    """The int8 serving tree under TP: its quantize equals the shards of the
    single-device one, its forward the single-device port int8 forward's,
    and the JAX int8 forward within the port's int8 gate."""
    fused = tq.quantize_dit_params(tm.fuse_backbone_qkv(trees["dit"][3]))
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    bdef = BACKBONES["DiT"]
    single = bdef.forward(fused, bdef.statics_cls(ModelArch(**ARCH)), inp["x"], inp["cond"],
                          inp["text"], inp["time"], lengths=inp["lengths"]).numpy()
    mod, jarch, tree, _, _, _ = trees["dit"]
    want = _jax_forward(mod, jarch, jq.quantize_dit_params(jm.fuse_backbone_qkv(jx(tree))),
                        "dit")
    assert _rel_live(single, want) <= INT8_JAX_GATE
    for out in ranks:
        assert out["quantized_shards_equal"]
        assert _rel_live(out["dit_int8"].numpy(), single) <= REL
        assert _rel_live(out["dit_int8"].numpy(), want) <= INT8_JAX_GATE


def test_mesh_config_matches_jax():
    import dataclasses

    from f5tts_tpu.config import MeshConfig as JMeshConfig
    from f5tts_tpu_torch.config import MeshConfig

    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMeshConfig())
    assert pmesh.Mesh(**dataclasses.asdict(MeshConfig(data=2, model=4))).shape == {
        "data": 2, "model": 4}


def test_local_heads_and_divisibility():
    tp = [pmesh.Mesh(1, 2, r).tp for r in range(2)]
    assert tm.local_heads(16, 1, tp[0]) == (8, 1) and tm.local_heads(16, 1, tp[1]) == (8, 0)
    assert tm.local_heads(16, None, tp[1]) == (8, None)
    assert tm.local_heads(16, 12, tp[1]) == (8, 4)
    with pytest.raises(ValueError, match="heads do not split"):
        BACKBONES["DiT"].statics_cls(ModelArch(**dict(ARCH, heads=3, dim_head=32)),
                                     tp=pmesh.Mesh(1, 2, 0).tp)


def test_flash_attention_sharded_matches_jax():
    """Each (data, model) rank's output is its block of the JAX
    flash_attention_sharded output on a 4 x 2 mesh of CPU devices."""
    b, h, n, d = 4, 8, 256, 32
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * 0.3 for _ in range(3))
    lengths = np.asarray([256, 192, 128, 256], np.int32)
    want = np.asarray(jax.jit(lambda *a: jattn_sharded(*a))(q, k, v, lengths))
    for rank in range(8):
        mesh = pmesh.Mesh(4, 2, rank)
        got = tattn.flash_attention_sharded(*(torch.from_numpy(t) for t in (q, k, v, lengths)),
                                            mesh)
        rows = slice(mesh.data_rank, mesh.data_rank + 1)
        heads = slice(mesh.model_rank * 4, mesh.model_rank * 4 + 4)
        live = lengths[rows][0]
        np.testing.assert_allclose(got.numpy()[:, :, :live], want[rows, heads][:, :, :live],
                                   atol=2e-5, rtol=1e-4)


def jattn_sharded(q, k, v, lengths):
    from f5tts_tpu.ops.attention import flash_attention_sharded

    return flash_attention_sharded(q, k, v, lengths, mesh=jmesh.make_mesh(data=4, model=2))
