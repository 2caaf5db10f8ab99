"""The selective scan's plain twins and dispatch on the CPU: the plain
backward `ref.ssm_scan_bwd_plain` (what the CUDA backward computes)
against autograd of the plain loop `selective_scan.ssm_scan_plain`, the
port's SSM block's gradients against `jax.grad` of the reference block, and
`SelectiveScan` / `ops.ssm_scan` on CPU tensors.  The CUDA kernels run only
on a GPU (tests/test_torch_cuda.py).

Inputs come from a numpy seed.  Bars:
  * the plain backward against autograd in float64: 1e-10 of max(max
    |want|, 1) (the same sums in another order; measured ~3e-16);
  * the fp32 block's gradients against JAX's: 1e-5 of the largest
    magnitude (fp32 sums in another order);
  * `SelectiveScan` on CPU tensors (the plain twins on both sides), with
    and without `torch.utils.checkpoint`: equal;
  * the CUDA kernels' chunk and carry order on the CPU
    (`ref.ssm_scan_chunked`, `ref.ssm_scan_bwd_plain` with a chunk) against
    the plain loop and its plain backward: float64 at 1e-12 of max(max |want|, 1)
    (relative max for y and h_last; the same sums in another order), fp32
    at the kernels' bars (1e-5 relative, 1e-4 of max(max |want|, 1))
    against the float64 loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as tckpt

from repro.models import blocks as jblocks
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import blocks as tblocks

SSM = dict(d_model=64, d_inner=64, state_dim=4, conv_k=4)
GRADS = ("ddt", "du", "db", "dc", "da", "dh0")


def _scan_inputs(s, n, *, d=8, strong=False, dtype=np.float64, seed=0):
    """(dt, u, b, c, a, h0) as numpy arrays and (dy, dh_last): dt =
    softplus(N(0, 1)) or, `strong`, U[50, 60], so that exp(dt a) underflows
    to 0 in float64 for the upper states (a = -(1 .. N) x e^(0.1 N)), or,
    `strong="kernel"`, chip_smoke's U[6, 10] (0 in fp32)."""
    rng = np.random.default_rng(seed)
    lo, hi = (6, 10) if strong == "kernel" else (50, 60)
    dt = (rng.uniform(lo, hi, (2, s, d)) if strong
          else np.log1p(np.exp(rng.standard_normal((2, s, d)))))
    u, dy = rng.standard_normal((2, 2, s, d))
    b, c = rng.standard_normal((2, 2, s, n))
    a = -np.arange(1, n + 1) * np.exp(0.1 * rng.standard_normal((d, n)))
    h0, dh = 0.3 * rng.standard_normal((2, 2, d, n))
    return [x.astype(dtype) for x in (dt, u, b, c, a, h0, dy, dh)]


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


def _held(got, want, bar):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= bar * max(
            w.abs().max().item(), 1.0)


@pytest.mark.parametrize("s,n,with_h0,with_dh,strong", [
    (1, 4, False, False, False),
    (1, 16, True, True, False),
    (33, 4, True, True, False),
    (33, 16, False, True, False),
    (33, 16, True, False, False),
    (70, 16, True, True, True),
])
def test_plain_backward_matches_autograd_in_float64(s, n, with_h0, with_dh,
                                                     strong):
    """`ref.ssm_scan_bwd_plain` (span recompute from checkpoints every 32
    tokens) against `torch.autograd.grad` through the plain loop, float64:
    S = 1 (decode) and 33 / 70 (not a multiple of the span), with and
    without h0 and dh_last; at strong decay some exp(dt a) are exactly 0,
    and every gradient stays finite."""
    dt, u, b, c, a, h0, dy, dh = _scan_inputs(s, n, strong=strong)
    ins = _t(dt, u, b, c, a, h0, grad=True)
    if not with_h0:
        ins[5] = None
    if strong:
        assert (np.exp(dt[..., None] * a) == 0).any()
    y, h_last = ss.ssm_scan_plain(*ins)
    dy_t, dh_t = _t(dy, dh)
    loss = (y * dy_t).sum() + ((h_last * dh_t).sum() if with_dh else 0)
    need = [t for t in ins if t is not None]
    want = torch.autograd.grad(loss, need)
    got = ref.ssm_scan_bwd_plain(*(None if t is None else t.detach()
                                   for t in ins), dy_t,
                                 dh_t if with_dh else None)
    assert len(got) == len(GRADS) and got[5].shape == (2, 8, n)
    _held(got[:len(need)], want, 1e-10)


def test_plain_checkpoints_are_the_loop_states():
    """`ref.ssm_checkpoints` gives h before tokens 0, 32, 64 of the loop:
    the h_last of the loop over the tokens before each."""
    dt, u, b, c, a, h0, *_ = _t(*_scan_inputs(70, 4))
    ck = ref.ssm_checkpoints(dt, u, b, a, h0, 32)
    assert ck.shape == (2, 3, 8, 4)
    assert torch.equal(ck[:, 0], h0)
    for i, t in ((1, 32), (2, 64)):
        _, h = ss.ssm_scan_plain(dt[:, :t], u[:, :t], b[:, :t], c[:, :t], a,
                                 h0)
        assert (ck[:, i] - h).abs().max().item() <= 1e-12


@functools.lru_cache(maxsize=None)
def _ssm_params():
    jd = jblocks.SSMDims(**SSM)
    jp = jax.jit(jblocks.init_ssm, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jd)
    return jd, jp


@pytest.mark.parametrize("with_state", [False, True])
def test_block_grads_match_jax(with_state):
    """autograd through the port's fp32 `blocks.ssm` (its scan the plain
    loop on the CPU) against `jax.grad` of `repro.models.blocks.ssm`, for x
    and every SSM param, 1e-5 of the largest magnitude; with a bf16 state
    on both sides (the gradient of the state too)."""
    jd, jp = _ssm_params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, SSM["d_model"])).astype(np.float32)
    w = rng.standard_normal((2, 40, SSM["d_model"])).astype(np.float32)
    state = {"conv": rng.standard_normal(
        (2, SSM["conv_k"] - 1, SSM["d_inner"])).astype(np.float32),
        "h": 0.3 * rng.standard_normal(
            (2, SSM["d_inner"], SSM["state_dim"])).astype(np.float32)}
    js = ({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in state.items()}
          if with_state else None)

    def jloss(p, x_):
        return (jblocks.ssm(p, jd, x_, state=js)[0] * w).sum()
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = params_from_jax({"s": jax.tree.map(np.asarray, jp)}, "cpu",
                         torch.float32)["s"]
    for t in tp.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = ({k: torch.from_numpy(v).bfloat16() for k, v in state.items()}
          if with_state else None)
    out, _ = tblocks.ssm(tp, tblocks.SSMDims(**SSM), tx, state=ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *tp.values()])
    want = [np.asarray(jgx)] + [np.asarray(jgp[k]) for k in tp]
    assert set(tp) == set(jgp)
    for name, g, wnt in zip(["x", *tp], grads, want):
        assert g.shape == wnt.shape, name
        err = np.abs(g.numpy() - wnt).max() / np.abs(wnt).max()
        assert err <= 1e-5, (name, err)


def _fp32_inputs(s=40, n=4, grad=True):
    dt, u, b, c, a, h0, dy, dh = _scan_inputs(s, n, dtype=np.float32)
    return _t(dt, u, b, c, a, h0, grad=grad), _t(dy, dh)


def test_function_on_cpu_tensors_matches_plain_autograd():
    """`SelectiveScan.apply` on CPU tensors (the plain loop forward, the
    plain backward twin) gives the gradients autograd takes through the
    loop, within fp32 sums in another order, h0's included."""
    ins, (dy, dh) = _fp32_inputs()
    y, h = ss.SelectiveScan.apply(*ins, True)
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    y, h = ss.ssm_scan_plain(*ins)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    _held(got, want, 1e-5)


def test_function_under_checkpoint_equals_without():
    """`ops.ssm_scan`'s path through `SelectiveScan`, on CPU tensors, under
    `torch.utils.checkpoint(use_reentrant=False)` (the forward run again in
    the backward, as remat "full" runs it) gives the same gradients as
    without."""
    ins, (dy, dh) = _fp32_inputs()

    def run(*xs):
        y, h = ss.SelectiveScan.apply(*xs, True)
        return (y * dy).sum() + (h * dh).sum()
    want = torch.autograd.grad(run(*ins), ins)
    got = torch.autograd.grad(
        tckpt.checkpoint(run, *ins, use_reentrant=False), ins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_without_grad_saves_nothing():
    """grad=False: the forward saves nothing, and a backward through it
    raises instead of handing back zeros."""
    ins, _ = _fp32_inputs()
    y, _ = ss.SelectiveScan.apply(*ins, False)
    with pytest.raises(RuntimeError, match="grad=False"):
        y.sum().backward()


def test_dispatch():
    """`ops.ssm_scan`: the plain loop on CPU tensors, differentiable;
    force="kernel" raises there; "plain" and "naive" give the loop; an
    unknown force raises; the wrapper counts no launch on the CPU."""
    ins, _ = _fp32_inputs(grad=False)
    before = ss.selective_scan.launches
    want = ss.ssm_scan_plain(*ins)
    for force in (None, "plain", "naive"):
        got = ops.ssm_scan(*ins, force=force)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ssm_scan(*ins, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.ssm_scan(*ins, force="bogus")
    assert ss.selective_scan_fwd(*ins, want_ckpt=True)[2] is None
    assert ss.selective_scan.launches == before


# chunks of CHUNK tokens on the CPU (a multiple of CKPT_EVERY, small so the
# loops stay quick): S = 1, CHUNK - 1, CHUNK, CHUNK + 1, a ragged last chunk
# and whole chunks
CHUNK = 32
CHUNKED = [
    (1, 4, True, True, False),
    (CHUNK - 1, 4, False, True, False),
    (CHUNK, 16, True, False, False),
    (CHUNK + 1, 4, True, True, False),
    (2 * CHUNK + 5, 16, False, False, False),
    (3 * CHUNK, 4, True, True, False),
    (2 * CHUNK + 5, 4, True, True, True),
    (3 * CHUNK + 7, 16, False, True, "kernel"),
]


def _chunked_inputs(s, n, with_h0, with_dh, strong, dtype):
    dt, u, b, c, a, h0, dy, dh = _t(*_scan_inputs(s, n, strong=strong,
                                                  dtype=dtype))
    return (dt, u, b, c, a, h0 if with_h0 else None), dy, (
        dh if with_dh else None)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("s,n,with_h0,with_dh,strong", CHUNKED)
def test_chunked_forward_matches_the_loop(s, n, with_h0, with_dh, strong):
    """`ref.ssm_scan_chunked` (each chunk walked from zero, the carry
    exp(a sdt) h + hloc, each chunk walked again) against the plain loop:
    float64 within 1e-12, fp32 within the kernel's 1e-5 (relative max),
    every value finite, also where each chunk's decay underflows to 0."""
    args, _, _ = _chunked_inputs(s, n, with_h0, with_dh, strong, np.float64)
    want_y, want_h = ss.ssm_scan_plain(*args)
    y, h = ref.ssm_scan_chunked(*args, CHUNK)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert _rel(y, want_y) <= 1e-12 and _rel(h, want_h) <= 1e-12
    args32, _, _ = _chunked_inputs(s, n, with_h0, with_dh, strong,
                                   np.float32)
    y32, h32 = ref.ssm_scan_chunked(*args32, CHUNK)
    assert torch.isfinite(y32).all() and torch.isfinite(h32).all()
    assert _rel(y32.double(), want_y) <= 1e-5
    assert _rel(h32.double(), want_h) <= 1e-5


@pytest.mark.parametrize("s,n,with_h0,with_dh,strong", CHUNKED)
def test_chunked_backward_matches_the_plain_backward(s, n, with_h0, with_dh,
                                                     strong):
    """`ref.ssm_scan_bwd_plain` with a chunk (each chunk but the first
    walked back from R = 0, the reverse carry from dh_last, each chunk
    walked back from its R) against it without: float64 within 1e-12, fp32
    within the kernel's 1e-4 of max(max |want|, 1), all six gradients
    finite."""
    args, dy, dh = _chunked_inputs(s, n, with_h0, with_dh, strong,
                                   np.float64)
    want = ref.ssm_scan_bwd_plain(*args, dy, dh)
    got = ref.ssm_scan_bwd_plain(*args, dy, dh, chunk=CHUNK)
    _held(got, want, 1e-12)
    args32, dy32, dh32 = _chunked_inputs(s, n, with_h0, with_dh, strong,
                                         np.float32)
    got32 = ref.ssm_scan_bwd_plain(*args32, dy32, dh32, chunk=CHUNK)
    _held([g.double() for g in got32], want, 1e-4)


def test_chunked_carry_underflows_without_harm():
    """At the strong-decay draw every chunk's decay exp(a sdt) is 0 in the
    upper states of fp32, and the carry stays finite: it multiplies by the
    decay and never divides by it."""
    (dt, _, _, _, a, _), _, _ = _chunked_inputs(3 * CHUNK + 7, 16, True,
                                                True, "kernel", np.float32)
    sdt = dt[:, :CHUNK].sum(1)
    assert (torch.exp(sdt[..., None] * a) == 0).any()
    local = torch.randn(2, 3, 8, 16)
    out = ref.ssm_chunk_carry(local, torch.stack([sdt] * 3, 1), a, None)
    assert torch.isfinite(out).all() and torch.equal(out[:, 0],
                                                     torch.zeros(2, 8, 16))


def test_chunk_must_hold_whole_spans():
    """The backward's chunks restart R at a span's end: a chunk that is not
    a multiple of the checkpoint span raises."""
    args, dy, dh = _chunked_inputs(40, 4, True, True, False, np.float64)
    with pytest.raises(ValueError, match="multiple"):
        ref.ssm_scan_bwd_plain(*args, dy, dh, ckpt_every=16, chunk=24)


def test_constants_match_the_kernel_source():
    """CKPT_EVERY and CHANNELS are the source's kCkptEvery and kChannels,
    and CHUNK holds whole checkpoint spans."""
    src = (ss.build.CSRC / "selective_scan.cu").read_text()
    for name, value in (("kCkptEvery", ss.CKPT_EVERY),
                        ("kChannels", ss.CHANNELS)):
        assert f"constexpr int {name} = {value};" in src
    assert ss.CHUNK % ss.CKPT_EVERY == 0
