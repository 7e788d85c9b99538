"""The port's tensor-parallel serve (launch/tensor_parallel.py;
launch/steps.py make_prefill_step / make_decode_step(mesh=); launch/serve
.py generate(mesh=)) across 4 gloo CPU processes, against the reference's
jitted prefill and decode steps and the port's single-device serve.

One launch (tests/_torch_tp_serve_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh: params placed by ``param_pspec(train=False)``,
the batch split over ``data`` where it divides, every cache leaf placed
by ``cache_pspec``.  Cases (the rank program's CASES): reduced
smollm-135m (its KV cache split on heads), qwen2.5-14b at 3/1 heads (the
d_model fallback; the cache split on the sequence), qwen3-14b at batch 1
(replicated over ``data``), gemma3-1b at 3/1 heads, one (L, G) cycle,
softcaps 50/30 and a prompt of 17 (25 positions, which ``model`` does
not divide: the replicated cache; its window of 16 binds), paligemma-3b
(4 query heads split, 1 KV head, 8 patches; sequence-split), whisper-tiny
at 3 heads and a vocab of 500 padded to 512 (32 frames; its self and
cross caches sequence-split), and smollm at a prompt of 2048, whose
prefill takes ``attention_flash`` under the mesh.  Batch 2 (qwen3: 1),
prompt 16, 8 new tokens.  Weights are the reference's initialisation,
carried over with repro_torch.convert; prompts, frames and patches come
from numpy seeds.

While the ranks run, this process runs the port's single-device serve
(``serve_plain``, one torch thread) and the reference: its jitted
``prefill`` at the cache's length (what its ``make_prefill_step`` runs,
which takes no length) and its jitted ``make_decode_step``.

Gates (test_torch_serve.py's): against the reference, the prefill's and
every decode step's logits within 1e-4 of the largest (real-vocab)
magnitude and every cache leaf within one bf16 step of its magnitude
(1e-2); against the single-device port, the prefill's logits within
1e-5, the cache within one bf16 step, greedy tokens equal.  Decode steps
are held each step from an f32 copy of the single-device serve's cache,
with its token, on all three: a bf16 cache computed apart differs by a
rounding here and there, one of which moves a logit by up to ~2e-5 of
the largest, free-running decode carries them on, and a step's own k/v
rounded to bf16 or not moves it by ~5e-4 (the free runs' tokens are held
equal, their caches within one bf16 step).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as TM

import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
from test_torch_tensor_parallel import finish_ranks

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
SIZES = dict(zip(("data", "model"), R.MESH))
CASES = tuple(S.CASES)
BF16_STEP = 1e-2           # one bf16 step of a leaf's magnitude
# how cache_pspec places each case's caches at model 2: the KV heads,
# the sequence or nothing ("whole")
SPLITS = {"smollm-135m": {"k": "heads"}, "qwen2.5-14b": {"k": "seq"},
          "qwen3-14b": {"k": "heads"}, "gemma3-1b": {"k": "whole"},
          "paligemma-3b": {"k": "seq"},
          "whisper-tiny": {"k": "seq", "cross_k": "seq"},
          "smollm-2048": {"k": "heads"}}


def case_of(name):
    arch, rows, prompt = S.CASES[name]
    return arch, rows, prompt, R.config(arch, get_arch)


def make_case(name, seed):
    """The reference's params, their numpy leaves and the prompt batch."""
    arch, rows, prompt, cfg = case_of(name)
    jp = JM.init_model(R.config(arch, jget_arch), jax.random.key(seed))
    weights = {R.path_key(p): np.asarray(x)
               for p, x in SH.tree_paths(jax.tree.map(np.asarray, jp))}
    rng = np.random.default_rng(seed + 300)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, prompt))
             .astype(np.int32)}
    if cfg.frontend:
        n = cfg.encoder_seq if cfg.frontend == "audio" else cfg.prefix_len
        batch[R.STUB[cfg.frontend]] = (0.1 * rng.standard_normal(
            (rows, n, cfg.d_model))).astype(np.float32)
    return {"jp": jp, "w": weights, "batch": batch}


def run_plain(name, case):
    """The port's single-device serve: logits, tokens and (numpy) caches
    after the prefill and each step."""
    _, _, prompt, cfg = case_of(name)
    logits, toks, caches = S.serve_plain(
        cfg, params_from_numpy(R.nest(case["w"])),
        {k: torch.from_numpy(v) for k, v in case["batch"].items()}, prompt)
    return ([x.numpy() for x in logits], toks.numpy(),
            [numpy_tree(c) for c in caches])


def numpy_tree(cache):
    return {R.path_key(p): np.asarray(x.float() if torch.is_tensor(x) else
                                      np.asarray(x, np.float32))
            for p, x in SH.tree_paths(cache)}


def run_reference(name, case, plain):
    """The reference's prefill, then each decode step from an f32 copy of
    the port's single-device cache and its token: logits and caches
    (numpy)."""
    arch, _, prompt, _ = case_of(name)
    jcfg = R.config(arch, jget_arch)
    scfg = dataclasses.replace(jcfg, attn_batch_shard=False,
                               seq_parallel=False)
    length = S.cache_len(jcfg, prompt)
    prefill = jax.jit(lambda p, b: JM.prefill(scfg, p, b, cache_len=length))
    decode = jax.jit(jmake_decode_step(jcfg))
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    last, cache = prefill(case["jp"], batch)
    logits, caches = [np.asarray(last)], [numpy_tree(jax.tree.map(
        lambda x: np.asarray(x, np.float32), cache))]
    _, toks, plain_caches = plain
    start = prompt + TM.vision_prefix(jcfg)
    for i in range(S.NEW - 1):
        jc = R.nest({k: jnp.asarray(v) for k, v in plain_caches[i].items()})
        out, cache = decode(case["jp"], jnp.asarray(toks[:, i]),
                            jnp.int32(start + i), jc)
        logits.append(np.asarray(out))
        caches.append(numpy_tree(jax.tree.map(
            lambda x: np.asarray(x, np.float32), cache)))
    return logits, caches


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """{case: inputs}, {case: single-device run}, {case: reference run},
    the ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_serve")
    cases = {n: make_case(n, seed) for seed, n in enumerate(CASES)}
    inputs = {}
    for n, c in cases.items():
        inputs.update({f"{n}.w.{k}": v for k, v in c["w"].items()})
        inputs[f"{n}.tokens"] = c["batch"]["tokens"]
        for k in R.STUB.values():
            if k in c["batch"]:
                inputs[f"{n}.stub"] = c["batch"][k]
    procs, logs = R.start_ranks(tmp, inputs, script=S.__file__)
    threads = torch.get_num_threads()
    try:
        # one torch thread beside the four ranks (test_torch_qwen.py's
        # reason: small ops on a busy host)
        torch.set_num_threads(1)
        plain = {n: run_plain(n, c) for n, c in cases.items()}
        ref = {n: run_reference(n, c, plain[n]) for n, c in cases.items()}
    finally:
        torch.set_num_threads(threads)
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return cases, plain, ref, ranks


def assert_logits_near(got, want, vocab, tol, what):
    """Within ``tol`` of the largest magnitude of the real vocab's
    columns (the padded ones are -1e30 on both sides)."""
    scale = np.abs(want[..., :vocab]).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def leaf_rows(key, value, rows):
    """A global cache leaf's rows of a rank's batch slice."""
    return value[:, rows] if key.startswith("scan/") else value[rows]


def assert_cache_near(rk, name, t, want, what):
    rows = rk[f"{name}.rows"]
    for key, v in want.items():
        got = rk[f"{name}.{t}.cache.{key}.value"]
        v = leaf_rows(key, v, rows)
        assert got.shape == v.shape, (what, key)
        err, scale = np.abs(got - v).max(), np.abs(v).max()
        assert err <= BF16_STEP * scale, (what, t, key, err, scale)


@pytest.mark.parametrize("name", CASES)
def test_prefill_matches_reference_and_single_device(launch, name):
    """The prefill's last logits within 1e-4 of the reference's and 1e-5
    of the single-device port's; its cache within one bf16 step of
    both."""
    _, plain, ref, ranks = launch
    vocab = case_of(name)[3].vocab
    for rk in ranks:
        rows = rk[f"{name}.rows"]
        got = rk[f"{name}.0.logits"]
        assert_logits_near(got, ref[name][0][0][rows], vocab, 1e-4, "ref")
        assert_logits_near(got, plain[name][0][0][rows], vocab, 1e-5,
                           "single")
        assert_cache_near(rk, name, 0, ref[name][1][0], "ref")
        assert_cache_near(rk, name, 0, plain[name][2][0], "single")


@pytest.mark.parametrize("name", CASES)
def test_decode_steps_match_reference_and_single_device(launch, name):
    """Each decode step from an f32 copy of the single-device serve's
    cache, with its token: within 1e-5 of the single-device step and 1e-4
    of the reference's step on the same."""
    _, _, ref, ranks = launch
    vocab = case_of(name)[3].vocab
    for rk in ranks:
        rows = rk[f"{name}.rows"]
        for t in range(1, S.NEW):
            got = rk[f"{name}.forced.{t}"]
            assert_logits_near(got, rk[f"{name}.forced_plain.{t}"][rows],
                               vocab, 1e-5, ("single", t))
            assert_logits_near(got, ref[name][0][t][rows], vocab, 1e-4,
                               ("ref", t))


@pytest.mark.parametrize("name", CASES)
def test_greedy_tokens_equal(launch, name):
    """generate(mesh=)'s tokens on every rank (the whole batch) equal the
    single-device port's, and the reference picks the same token after
    the prefill and after each step of the same history."""
    _, plain, ref, ranks = launch
    toks = plain[name][1]
    np.testing.assert_array_equal(
        np.stack([np.argmax(x, -1) for x in ref[name][0]], 1), toks)
    for rk in ranks:
        np.testing.assert_array_equal(rk[f"{name}.generate"], toks)


@pytest.mark.parametrize("name", CASES)
def test_free_running_cache_within_a_bf16_step(launch, name):
    """generate(mesh=)'s cache after each decode step within one bf16 step
    of the single-device serve's and of the reference step's."""
    _, plain, ref, ranks = launch
    for rk in ranks:
        for t in range(1, S.NEW):
            assert_cache_near(rk, name, t, plain[name][2][t], "single")
            assert_cache_near(rk, name, t, ref[name][1][t], "ref")


def expected(name, length):
    """{path key: (global shape, cache_pspec spec)} of the case's cache
    of ``length`` positions."""
    _, rows, _, cfg = case_of(name)
    meta = TM.init_cache(cfg, rows, length, device="meta")
    return {R.path_key(path): (tuple(x.shape),
                               SH.cache_pspec(path, x, cfg, axis_sizes=SIZES))
            for path, x in SH.tree_paths(meta)}


def placement_of(spec) -> str:
    dims = [d for d, a in enumerate(spec) if a == "model"]
    return f"S{dims[0]}" if dims else "R"


def split_of(shape, spec) -> str:
    name = placement_of(spec)
    if name == "R":
        return "whole"
    return "heads" if int(name[1:]) == len(shape) - 2 else "seq"


@pytest.mark.parametrize("name", CASES)
def test_cache_placements_and_bytes(launch, name):
    """Every cache leaf after the prefill and after each decode step is
    placed as cache_pspec says (Shard on the model dim it names, else
    Replicate) and a rank holds sharding.placed_bytes of it; the batch
    is split over data where it divides; a placed cache of about twice
    the length is placed alike."""
    _, _, prompt, cfg = case_of(name)
    length = S.cache_len(cfg, prompt)
    want = expected(name, length)
    for key, (shape, spec) in want.items():
        leaf = key.rsplit("/", 1)[-1]
        assert split_of(shape, spec) == SPLITS[name][
            "cross_k" if leaf.startswith("cross") else "k"], key
        b = 1 if key.startswith("scan/") else 0
        assert (spec[b] == "data") == (shape[b] % R.MESH[0] == 0), key
    long = expected(name, S.long_len(length))
    _, _, _, ranks = launch
    for rk in ranks:
        for t in range(S.NEW):
            for key, (shape, spec) in want.items():
                k = f"{name}.{t}.cache.{key}"
                assert str(rk[f"{k}.placement"]) == placement_of(spec), k
                assert int(rk[f"{k}.bytes"]) == SH.placed_bytes(
                    shape, torch.bfloat16, spec, SIZES), k
        for key, (_, spec) in long.items():
            assert str(rk[f"{name}.long.{key}.placement"]) == \
                placement_of(spec), key
            assert placement_of(spec) == placement_of(want[key][1])


@pytest.mark.parametrize("name", CASES)
def test_decode_communication_does_not_grow_with_the_cache(launch, name):
    """A decode step's collectives (each op and its bytes) on the
    prefill's cache and on a placed cache of about twice its length are
    the same: no cache-sized tensor moves."""
    _, _, _, ranks = launch
    for rk in ranks:
        ops = list(rk[f"{name}.comms"])
        assert ops, name
        assert ops == list(rk[f"{name}.comms_long"])


def test_every_cache_placement_is_reached():
    """The cases reach each of cache_pspec's branches: KV heads,
    sequence and replicated over model; a batch split over data and one
    replicated there; the cross caches."""
    kinds = {s for d in SPLITS.values() for s in d.values()}
    assert kinds == {"heads", "seq", "whole"}
    assert "cross_k" in SPLITS["whisper-tiny"]
    assert {S.CASES[n][1] % R.MESH[0] for n in CASES} == {0, 1}


def test_prefill_at_2048_takes_attention_flash(launch):
    """At a prompt of 2048 every layer's prefill attention ran through
    attention_flash on every rank; below it none did."""
    _, _, _, ranks = launch
    for rk in ranks:
        for name in CASES:
            want = case_of(name)[3].n_layers if S.CASES[name][2] >= 2048 \
                else 0
            assert int(rk[f"{name}.flash"]) == want, name


def test_greedy_tokens_take_the_first_largest(launch):
    """tensor_parallel.greedy_tokens on vocab-sharded logits returns what
    torch.argmax returns on the whole rows, ties within and across the
    shards and padded columns included."""
    _, _, _, ranks = launch
    for rk in ranks:
        np.testing.assert_array_equal(rk["greedy.got"], rk["greedy.want"])


class _Mesh:
    """Stands for a ("data", "model") DeviceMesh where none is touched."""
    mesh_dim_names = ("data", "model")

    def __getitem__(self, name):
        return self


@pytest.mark.parametrize("maker", ("prefill", "decode"))
def test_mesh_steps_refuse_unplaced_params(maker):
    """The mesh path never serves on whole leaves: params not placed by
    place_serve_params raise before any work."""
    cfg = get_arch("smollm-135m").reduced()
    params = TM.init_model(cfg, 0)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="place_serve_params"):
        if maker == "prefill":
            make_prefill_step(cfg, _Mesh())(params, {"tokens": tokens})
        else:
            make_decode_step(cfg, _Mesh())(params, tokens[:, 0], 4,
                                           TM.init_cache(cfg, 1, 8))
