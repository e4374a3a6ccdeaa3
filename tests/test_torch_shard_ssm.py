"""SSM members served over ranks against the reference's sharded fleet:
reduced jamba-v0.1-52b (mamba, attention, dense and MoE FFNs) and
xlstm-350m (mLSTM / sLSTM, a tied vocab-parallel embedding).

The reference splits mamba's leaves over ``"model"`` by channels —
``in_proj``'s columns (the fused ``[x | z]``), ``conv_w`` / ``dt_w``
columns, ``x_proj`` / ``A_log`` / ``out_proj`` rows — and keeps the xLSTM
leaves whole (``repro/sharding/rules.py``); GSPMD computes the unsharded
forward.  The port runs mamba channel-parallel: each rank all-gathers its
``in_proj`` product and cuts its channels of x and of z out of it
(``models.ssm._mamba_local``), sums ``x_proj``'s and ``out_proj``'s
partial products over ``"model"``, and holds its channels' state; the
mLSTM and sLSTM run whole on every rank, their state too.

Each case runs over ``data 1 x model M`` (M = 2 and 4 gloo CPU ranks; the
reference on 4 fake devices, ``data 4 // M x model M``), float32,
``batch=2, max_seq=64, gen_tokens=4``, ``decode_impl="xla"``.  The
reference runs once, in a subprocess (``torch_shard_fleet_ref``), and
hands back its tokens at both M and its weights; the port loads them
(``LocalFleet.load_params``).  Its tokens must equal the reference's and
its own unsharded fleet's, a mismatch waived only at a near-tie (top-2
logit gap of the unsharded float32 member below 1e-4).  Within the port,
on the ranks: each rank's mamba leaves are exactly its blocks of the
whole weights and its mamba state the unsharded state's channels (an x/z
mix-up at M = 2 would fail here and in the tokens); the mLSTM's conv
state is whole; jamba's attention layer gives bitwise equal tokens under
``shardmap`` and ``xla`` (``build_serve_steps``); after a drain every
slot is free (a contiguous lane has no block pool).
"""

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MD
from repro_torch.models import ssm as S
from repro_torch.serving import serve_lib
from repro_torch.serving.fleet import LocalFleet, hash_tokens
from repro_torch.sharding import rules as R
from torch_shard_fleet_ref import near_tie
from torch_shard_fleet_ref import reference as fleet_reference

CASES = {"jamba-v0.1-52b": {"dtype": "float32"},
         "xlstm-350m": {"dtype": "float32"}}
MODELS = (2, 4)
KW = dict(reduced=True, batch=2, max_seq=64, gen_tokens=4)
PROMPTS = ["shard me across hosts",
           "a second request that shares nothing with the first one",
           "tiny", " ".join(f"w{i}" for i in range(30))]
MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A_log",
         "D", "out_proj")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return fleet_reference(tmp_path_factory.mktemp("ssm"), CASES, MODELS,
                           KW, PROMPTS)


def _cfg(arch):
    return get_reduced(arch).replace(**CASES[arch])


def _same_or_near_tie(arch, named, got, want):
    cfg = _cfg(arch)
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            ids = hash_tokens(prompt, cfg.vocab_size,
                              KW["max_seq"] - KW["gen_tokens"] - 1)
            assert near_tie(cfg, named, ids, a, b), (arch, prompt, a, b)


def _fleet(arch, **kw):
    return LocalFleet([arch], arch_overrides={arch: CASES[arch]},
                      decode_impl="xla", device="cpu", warmup=False,
                      **dict(KW, **kw))


def _rank_blocks(shard):
    """One rank: its coordinates, every leaf's spec and its mamba
    leaves."""
    out = {"coords": shard.mesh.coords, "leaves": {}, "specs": {}}
    for name, p in shard.params.named_parameters():
        spec = getattr(p, "_spec", None)
        # plain tuples: a ``P`` does not survive the gather's pickling
        out["specs"][name] = None if spec is None else tuple(spec)
        if ".mamba." in name:
            out["leaves"][name] = p.detach().clone()
    return out


def _rank_state(cache):
    """One rank: every SSM leaf of its contiguous cache."""
    return {f"{g}/{b}/{leaf}": t.clone() for g, grp in cache.items()
            if g.startswith("g") for b, lv in grp.items()
            for leaf, t in lv.items() if leaf in ("h", "conv", "C", "n")}


def _steps_tokens(arch, impl, model):
    """One rank: ``build_serve_steps`` prefill + 6 decodes of two rows at
    one depth (scalar ``pos``) on ``data 1 x model M``."""
    mesh = LM.make_host_mesh(model)
    cfg = _cfg(arch).replace(decode_impl=impl)
    params = MD.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                            mesh=mesh)
    prefill, decode, _ = serve_lib.build_serve_steps(cfg, mesh, 2, 32)
    cache = MD.init_cache(cfg, 2, 32, "cpu", mesh=mesh)
    nxt, cache = prefill(params, torch.tensor([[5, 9, 13, 2], [7, 7, 1, 3]],
                                              dtype=torch.int32), cache)
    out = [nxt]
    for _ in range(6):
        nxt, cache = decode(params, nxt[:, None], cache)
        out.append(nxt)
    attn = next(f"b{j}" for j, s in enumerate(cfg.groups[0].period)
                if s.mixer == "attn")
    split = any(getattr(t, "_seq_split", False)
                for t in cache["g0"][attn].values())
    return torch.stack(out, 1).tolist(), split


def _check_mamba_blocks(cfg, ranks, named, model):
    """Each rank's mamba leaves are exactly its blocks of the whole
    weights under the rules: ``in_proj`` the rank's columns of the fused
    [x | z] (at M = 2, rank 0 all of x), the others its channels."""
    di = S.mamba_dims(cfg)[0]
    for r in ranks:
        j = r["coords"]["model"]
        assert r["leaves"], "no mamba leaf"
        for name, t in r["leaves"].items():
            leaf = name.rsplit(".", 1)[-1]
            whole = named[name]
            spec = r["specs"][name]
            if leaf == "in_proj":
                assert spec == ("data", "model")
                n = 2 * di // model
                want = whole[:, j * n:(j + 1) * n]
            elif leaf in ("conv_w", "dt_w"):
                assert spec == (None, "model")
                n = di // model
                want = whole[:, j * n:(j + 1) * n]
            elif leaf in ("x_proj", "A_log", "out_proj"):
                assert spec[0] == "model"
                n = di // model
                want = whole[j * n:(j + 1) * n]
            else:                      # conv_b, dt_b, D: whole
                assert spec == (None,)
                want = whole
            assert torch.equal(t, want), (name, j)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_ssm_fleet_matches_reference_and_unsharded(reference, arch,
                                                           model):
    ref_tokens, ref_split = reference[arch][model]
    named = reference[arch]["named"]
    cfg = _cfg(arch)
    plain = _fleet(arch)
    plain.load_params(arch, named)
    unsharded = [o["tokens"] for o in plain.generate(arch, PROMPTS)]
    _same_or_near_tie(arch, named, unsharded, ref_tokens)
    want_state = _rank_state(plain.schedulers[arch].cache)
    if arch.startswith("jamba"):
        assert {k.rsplit("/", 1)[-1] for k in ref_split} >= set(MAMBA) - {
            "conv_b", "dt_b", "D"} | {"embed"}
    else:
        assert ref_split == {"embed"}, ref_split
    with LM.host_ranks(model, device="cpu") as ctl:
        fleet = _fleet(arch, model_axis=model)
        assert fleet.mesh.shape == {"data": 1, "model": model}
        m = fleet.members[arch]
        assert not m.paged and m.exact_prefill
        fleet.load_params(arch, named)
        got = [o["tokens"] for o in fleet.generate(arch, PROMPTS)]
        _same_or_near_tie(arch, named, got, ref_tokens)
        _same_or_near_tie(arch, named, got, unsharded)
        sched = fleet.schedulers[arch]
        assert sched.pending == 0 and all(a is None for a in sched.active)
        ranks = ctl.run(m.shard, "apply", _rank_blocks, gather=True)
        states = ctl.gather(_rank_state, sched.cache)
        stats = fleet.rank_stats()
        assert all(s["collectives"]["calls"] > 0 for s in stats)
        if arch.startswith("jamba"):
            steps = {impl: ctl.gather(_steps_tokens, arch, impl, model)
                     for impl in ("shardmap", "xla")}
    # the port splits over "model" exactly the leaves the reference does
    assert {R.ref_path(cfg, n) for n, s in ranks[0]["specs"].items()
            if s is not None and "model" in s} == ref_split
    if arch.startswith("jamba"):
        _check_mamba_blocks(cfg, ranks, named, model)
        di = S.mamba_dims(cfg)[0]
        n = di // model
        for r, st in zip(ranks, states):
            j = r["coords"]["model"]
            for key, t in st.items():
                w = want_state[key]
                # h (R, B, di, N) / conv (R, B, K-1, di): the channels
                want = w[:, :, j * n:(j + 1) * n] if key.endswith("/h") \
                    else w[..., j * n:(j + 1) * n]
                assert t.shape == want.shape, key
                torch.testing.assert_close(t, want, rtol=1e-4, atol=1e-5)
        shard, split_s = zip(*steps["shardmap"])
        xla, split_x = zip(*steps["xla"])
        # shardmap: a sequence shard; xla: the rank's KV heads where they
        # divide the axis, else a sequence shard too (``kv_layout``)
        assert all(split_s)
        assert all(x == (cfg.n_kv_heads % model != 0) for x in split_x)
        assert all(s == shard[0] for s in shard)
        assert all(x == shard[0] for x in xla)
    else:
        assert not any(".mlstm." in n or ".slstm." in n
                       for n, s in ranks[0]["specs"].items()
                       if s is not None and "model" in s)
        di = S.mlstm_dims(cfg)[0]
        for st in states:
            conv = [t for k, t in st.items() if k.endswith("/b0/conv")]
            assert conv and all(t.shape[-1] == di for t in conv)
            for key, t in st.items():
                assert torch.equal(t, states[0][key]), key
