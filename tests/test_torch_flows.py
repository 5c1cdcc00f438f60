"""The port's flow plane (``enterprise_warp_tpu_torch/flows``, the PT
``flow`` family, ``serve --flow``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages:

- the coupling transforms (``affine`` and ``rqs``, with and without a
  context; the reference's zero-initialized last layers replaced in both
  by the same seeded weights) on 64 rows, some outside ``tail_bound``:
  forward, inverse, ``log_prob`` and ``sample_logq`` within atol/rtol
  1e-12; the round trip (1e-12) and the log-determinant against
  ``torch.autograd.functional.jacobian``'s slogdet;
- ``init_flow`` given the integer the reference draws from its key: the
  same permutations and weights; ``arch_token``, ``spec_to_json``,
  ``weights_digest`` and ``topology_token`` string-equal; an artifact
  saved by either package loads in the other with equal ``log_prob``;
- the training loss and its gradient on one minibatch against
  ``jax.value_and_grad`` (1e-10), one Adam step against the reference's
  ``_adam_step`` (1e-12);
- ``rescore_flow`` on injected draws, log q, lnL and log-prior: the
  reference's dict within 1e-12;
- ``propose_flow`` against the reference's ``flow_one`` algebra with the
  same draws (1e-12).

The two packages draw from different streams (threefry against a
``torch.Generator``), so whole runs are held by outcome: a fit recovers
an analytic Gaussian (the rescore's ``match``), a wrong target fails it,
a resumed fit is bit for bit the uninterrupted one, the flow family's
posterior matches the default families' with the reference test's
attribution bounds, and a zero-weight flow leaves the chain bit for bit
the flow-free one. The serve models run on the port's ``ServeDriver``
(the vector lane, packed rows bit-equal to alone) and through ``cli
serve --flow`` and ``flow_models:``.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.flows import coupling as R
from enterprise_warp_tpu.flows import model as RM
from enterprise_warp_tpu.flows import rescore as RR
from enterprise_warp_tpu.flows import train as RT
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.flows import (FlowPosterior, fit_flow,
                                             rescore_flow)
from enterprise_warp_tpu_torch.flows import coupling as P
from enterprise_warp_tpu_torch.flows import model as PM
from enterprise_warp_tpu_torch.flows import train as PT
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.samplers.ptmcmc import _FAM_NAMES, \
    propose_flow
from enterprise_warp_tpu_torch.serve import ServeDriver

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TOL = 1e-12
INT32_MAX = np.iinfo(np.int32).max


class GaussianLike(PriorMixin):
    """Analytic Gaussian likelihood in a uniform box (float64 torch)."""

    device = torch.device("cpu")

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu = torch.tensor(mu, dtype=torch.float64)
        self.sigma = torch.tensor(sigma, dtype=torch.float64)
        self.ndim = len(mu)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        z = (torch.as_tensor(theta, dtype=torch.float64) - self.mu) \
            / self.sigma
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.sigma))
                - 0.5 * self.ndim * math.log(2 * math.pi))


def _pair(kind, ctx=0, ndim=5, n_layers=4, hidden=16, key=3):
    """The reference's flow from ``PRNGKey(key)`` and the port's from the
    integer that key gives ``init_flow``, with the zero last layers and
    the standardization replaced by the same seeded weights: ``(spec_ref,
    spec_port, tree)``, ``tree`` the weights as the reference's pytree of
    numpy arrays."""
    k = jax.random.PRNGKey(key)
    rspec, rparams = R.init_flow(k, ndim, n_layers=n_layers, hidden=hidden,
                                 kind=kind, context_dim=ctx)
    seed = int(jax.random.randint(k, (), 0, INT32_MAX))
    tspec, _ = P.init_flow(seed, ndim, n_layers=n_layers, hidden=hidden,
                           kind=kind, context_dim=ctx, device="cpu")
    rng = np.random.default_rng(11)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    layers = tuple(dict(lp, w3=0.1 * rng.standard_normal(lp["w3"].shape),
                        b3=0.1 * rng.standard_normal(lp["b3"].shape))
                   for lp in tree["layers"])
    tree = dict(tree, layers=layers,
                loc=0.3 * rng.standard_normal(ndim),
                log_scale=0.2 * rng.standard_normal(ndim))
    return rspec, tspec, tree


def _ref_batch(fn, spec, tree, rows, ctx=None):
    """The reference's per-vector ``fn`` over rows, vmapped, as numpy."""
    if ctx is None:
        out = jax.vmap(lambda r: fn(spec, tree, r))(jnp.asarray(rows))
    else:
        out = jax.vmap(lambda r, c: fn(spec, tree, r, c))(
            jnp.asarray(rows), jnp.asarray(ctx))
    return jax.tree_util.tree_map(np.asarray, out)


def _rows(ndim, ctx, seed=5, n=64):
    """64 seeded rows, about a fifth beyond the tail bound of 5, and
    their contexts."""
    rng = np.random.default_rng(seed)
    u = 3.5 * rng.standard_normal((n, ndim))
    c = rng.standard_normal((n, ctx)) if ctx else None
    return u, c


def _t(a):
    return None if a is None else torch.as_tensor(a, dtype=torch.float64)


# ---------------------------------------------------------------- coupling

@pytest.mark.parametrize("kind", ["affine", "rqs"])
@pytest.mark.parametrize("ctx", [0, 3])
def test_transforms_match_the_reference(kind, ctx):
    rspec, tspec, tree = _pair(kind, ctx)
    pp = P.params_from_numpy(tree, "cpu")
    u, c = _rows(5, ctx)
    assert (np.abs(u) > 5.0).any()
    for name in ("flow_forward", "flow_inverse", "flow_sample_logq",
                 "flow_log_prob"):
        ref = _ref_batch(getattr(R, name), rspec, tree, u, c)
        got = getattr(P, name)(tspec, pp, _t(u), _t(c))
        if name == "flow_log_prob":
            ref, got = (ref,), (got,)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), a, rtol=TOL, atol=TOL,
                                       err_msg=f"{kind} ctx={ctx} {name}")


@pytest.mark.parametrize("kind", ["affine", "rqs"])
def test_round_trip_and_logdet_against_autograd(kind):
    _, tspec, tree = _pair(kind)
    pp = P.params_from_numpy(tree, "cpu")
    u, _ = _rows(5, 0, seed=8, n=16)
    x, ld = P.flow_forward(tspec, pp, _t(u))
    u2, ld_inv = P.flow_inverse(tspec, pp, x)
    np.testing.assert_allclose(u2.numpy(), u, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ld_inv.numpy(), -ld.numpy(), rtol=TOL,
                               atol=TOL)
    for i in range(len(u)):
        jac = torch.autograd.functional.jacobian(
            lambda z: P.flow_forward(tspec, pp, z[None])[0][0], _t(u[i]))
        np.testing.assert_allclose(float(ld[i]),
                                   float(torch.linalg.slogdet(jac)[1]),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["affine", "rqs"])
def test_init_flow_same_integer_same_flow(kind):
    k = jax.random.PRNGKey(7)
    rspec, rparams = R.init_flow(k, 12, n_layers=6, hidden=64, kind=kind)
    seed = int(jax.random.randint(k, (), 0, INT32_MAX))
    tspec, tparams = P.init_flow(seed, 12, n_layers=6, hidden=64,
                                 kind=kind, device="cpu")
    assert dataclasses.asdict(tspec) == dataclasses.asdict(rspec)
    assert tspec.perms == rspec.perms
    ref_leaves = jax.tree_util.tree_leaves(rparams)
    port_leaves = P.leaves(tparams)
    assert len(ref_leaves) == len(port_leaves) == 6 * 6 + 2
    for a, b in zip(ref_leaves, port_leaves):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = P.params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, rparams))
    with pytest.raises(ValueError):
        P.init_flow(0, 1, device="cpu")


def test_strings_and_digests_equal_the_reference():
    rspec, tspec, tree = _pair("rqs", 2)
    assert tspec.arch_token == rspec.arch_token
    assert P.spec_to_json(tspec) == R.spec_to_json(rspec)
    assert dataclasses.asdict(P.spec_from_json(R.spec_to_json(rspec))) \
        == dataclasses.asdict(rspec)
    pp = P.params_from_numpy(tree, "cpu")
    assert PM.weights_digest(pp) == RM.weights_digest(tree)
    rf = RM.FlowPosterior(rspec, tree, data_digest="abc123")
    tf = FlowPosterior(tspec, pp, data_digest="abc123", device="cpu")
    assert tf.topology_token == rf.topology_token
    for mode in ("sample", "log_prob"):
        assert tf.serve_view(mode).topology_token \
            == rf.serve_view(mode).topology_token


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_artifact_loads_across_packages(tmp_path, writer):
    rspec, tspec, tree = _pair("rqs")
    names = [f"q{i}" for i in range(5)]
    path = str(tmp_path / "flow.npz")
    if writer == "reference":
        RM.FlowPosterior(rspec, tree, param_names=names, data_digest="d0",
                         meta={"src": "ref"}).save(path)
        tf = FlowPosterior.load(path, device="cpu")
        rf = RM.FlowPosterior.load(path)
    else:
        FlowPosterior(tspec, P.params_from_numpy(tree, "cpu"),
                      param_names=names, data_digest="d0",
                      meta={"src": "port"}, device="cpu").save(path)
        rf = RM.FlowPosterior.load(path)
        tf = FlowPosterior.load(path, device="cpu")
    assert tf.param_names == rf.param_names == names
    assert tf.meta == rf.meta
    assert tf.topology_token == rf.topology_token
    x, _ = _rows(5, 0, seed=2)
    np.testing.assert_allclose(tf.log_prob(x).numpy(),
                               np.asarray(rf.log_prob(x)), rtol=TOL,
                               atol=TOL)
    # save -> load in the port is bit for bit
    path2 = str(tmp_path / "again.npz")
    tf.save(path2)
    back = FlowPosterior.load(path2, device="cpu")
    assert torch.equal(back.log_prob(x), tf.log_prob(x))
    assert back.topology_token == tf.topology_token


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("kind", ["affine", "rqs"])
def test_loss_and_gradient_match_value_and_grad(kind):
    rspec, tspec, tree = _pair(kind, ndim=4)
    rng = np.random.default_rng(3)
    xb = 2.0 * rng.standard_normal((32, 4))

    def loss(p):
        lp = jax.vmap(lambda r: R.flow_log_prob(rspec, p, r))(
            jnp.asarray(xb))
        return -jnp.mean(lp)
    rl, rg = jax.value_and_grad(loss)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    pp = P.params_from_numpy(tree, "cpu")
    flat = P.leaves(pp)
    for x in flat:
        x.requires_grad_(True)
    tl = PT.flow_nll(tspec, pp, _t(xb))
    tg = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-10,
                               atol=1e-10)
    for a, b in zip(jax.tree_util.tree_leaves(rg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-10)


def test_adam_step_matches_the_reference():
    _, _, tree = _pair("rqs", ndim=4)
    rng = np.random.default_rng(4)

    def like(scale, positive=False):
        t = jax.tree_util.tree_map(
            lambda a: scale * rng.standard_normal(a.shape), tree)
        return jax.tree_util.tree_map(np.abs, t) if positive else t
    m, v, g = like(0.1), like(0.01, positive=True), like(1.0)
    rp, rm, rv = RT._adam_step(*(jax.tree_util.tree_map(jnp.asarray, t)
                                 for t in (tree, m, v, g)), 3.0, 1e-3)
    lists = [[torch.as_tensor(np.array(a))
              for a in jax.tree_util.tree_leaves(t)] for t in (tree, m, v,
                                                               g)]
    PT._adam_step(*lists, 3.0, 1e-3)
    for ref, got in zip((rp, rm, rv), lists[:3]):
        for a, b in zip(jax.tree_util.tree_leaves(ref), got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                       atol=TOL)


def _trained_flow(rng_seed=0, n=4000, steps=400, kind="affine",
                  mu=(1.0, -2.0), sigma=(0.3, 0.7)):
    """A quick port fit to a known Gaussian (the reference test's);
    returns (flow, corpus)."""
    rng = np.random.default_rng(rng_seed)
    corpus = rng.normal(mu, sigma, size=(n, len(mu)))
    spec, params, info = fit_flow(corpus, steps=steps, batch=256,
                                  n_layers=4, hidden=32, kind=kind,
                                  seed=0, block=100, device="cpu")
    return FlowPosterior(spec, params, data_digest=info["data_digest"],
                         device="cpu"), corpus


@pytest.fixture(scope="module")
def trained():
    return _trained_flow()


def test_fit_recovers_gaussian_and_rescore_matches(trained):
    flow, corpus = trained
    like = GaussianLike([1.0, -2.0], [0.3, 0.7])
    res = rescore_flow(flow, like, n=512, seed=1, ref_chain=corpus,
                       device="cpu")
    assert res["match"] is True, res["checks"]
    assert res["ess_efficiency"] > 0.2
    assert res["n_nonfinite"] < 50
    assert res["weight_tail"]["max_weight"] < 0.2
    # the wrong target fails loudly
    wrong = GaussianLike([4.0, 3.0], [0.3, 0.7])
    assert rescore_flow(flow, wrong, n=512, seed=1,
                        device="cpu")["match"] is False


def test_fit_flow_telemetry(tmp_path):
    from enterprise_warp_tpu_torch.utils import telemetry
    corpus = np.random.default_rng(2).normal(0.0, 1.0, size=(500, 3))
    with telemetry.run_scope(str(tmp_path)):
        _, _, info = fit_flow(corpus, steps=100, batch=64, n_layers=2,
                              hidden=8, block=50, device="cpu")
    events = [json.loads(ln) for ln in open(tmp_path / "events.jsonl")]
    ft = [e for e in events if e["type"] == "flow_train"]
    assert [e["phase"] for e in ft] == ["start", "end"]
    assert ft[1]["steps"] == 100 and ft[1]["final_loss"] \
        == info["final_loss"] == info["loss_curve"][-1]
    hb = [e for e in events if e["type"] == "heartbeat"
          and e.get("phase") == "flow_train"]
    assert [e["step"] for e in hb] == [50, 100]
    assert telemetry.check_stream(str(tmp_path / "events.jsonl"))[0] == 0


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    rng = np.random.default_rng(5)
    corpus = rng.normal(0.0, 1.0, size=(1000, 2))
    kw = dict(batch=128, n_layers=2, hidden=16, kind="rqs", seed=3,
              block=50, device="cpu")
    _, whole, info0 = fit_flow(corpus, steps=400,
                               checkpoint_path=str(tmp_path / "a.npz"),
                               **kw)
    ck = str(tmp_path / "b.npz")
    _, _, info1 = fit_flow(corpus, steps=200, checkpoint_path=ck, **kw)
    assert info1["resumed_at"] == 0 and info1["steps"] == 200
    _, resumed, info2 = fit_flow(corpus, steps=400, checkpoint_path=ck,
                                 **kw)
    assert info2["resumed_at"] == 200 and info2["steps"] == 400
    for a, b in zip(P.leaves(whole), P.leaves(resumed)):
        assert torch.equal(a, b)
    assert info2["loss_curve"] == info0["loss_curve"][4:]
    # a corpus change invalidates the checkpoint (digest-verified)
    other = rng.normal(0.0, 1.0, size=(1000, 2))
    _, _, info3 = fit_flow(other, steps=400, checkpoint_path=ck, **kw)
    assert info3["resumed_at"] == 0


# ----------------------------------------------------------------- rescore

class _StubRef:
    def __init__(self, draws, logq):
        self.draws, self.logq = draws, logq

    def sample(self, key, n):
        return self.draws, self.logq


class _StubPort:
    def __init__(self, draws, logq):
        self.draws, self.logq = _t(draws), _t(logq)

    def to(self, dev):
        return self

    def sample(self, n, generator=None):
        return self.draws, self.logq


class _StubLike:
    def __init__(self, lnl, lnp, tensor):
        self.lnl, self.lnp = lnl, lnp
        self.cast = _t if tensor else np.asarray

    def loglike_batch(self, x):
        return self.cast(self.lnl)

    def log_prior(self, x):
        return self.cast(self.lnp)


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("bad", [0, 7])
def test_rescore_dict_matches_the_reference(bad):
    rng = np.random.default_rng(6)
    n = 256
    draws = rng.normal([1.0, -2.0, 0.5], [0.3, 0.7, 1.0], size=(n, 3))
    logq = -0.5 * np.sum(((draws - [1.0, -2.0, 0.5])
                          / [0.32, 0.68, 1.05]) ** 2, axis=1)
    lnl = logq + 0.3 * rng.standard_normal(n)
    lnp = np.full(n, -3.0)
    lnl[:bad] = -np.inf
    chain = rng.normal([1.0, -2.0, 0.5], [0.3, 0.7, 1.0], size=(500, 3))
    ref = RR.rescore_flow(_StubRef(draws, logq), _StubLike(lnl, lnp, False),
                          n=n, ref_chain=chain)
    got = rescore_flow(_StubPort(draws, logq), _StubLike(lnl, lnp, True),
                       n=n, ref_chain=chain, device="cpu")
    assert got["n_nonfinite"] == bad
    _close(ref, got)


# ------------------------------------------------------------------- serve

def test_serve_vector_lane_and_packed_vs_alone(trained, tmp_path):
    flow, _ = trained
    nd = flow.ndim
    rng = np.random.default_rng(9)
    jobs = [("t0", rng.standard_normal((3, nd))),
            ("t1", rng.standard_normal((5, nd))),
            ("t2", rng.standard_normal((2, nd)))]
    with ServeDriver(str(tmp_path / "pack"), buckets=(1, 8, 16)) as d:
        d.register("flow0", flow.serve_view("sample"), width=16)
        rids = [d.submit(t, "flow0", th) for t, th in jobs]
        d.run()
        packed = [d.results[r] for r in rids]
        summary = d.summary()
    assert summary["dropped_requests"] == 0
    for (_, th), res in zip(jobs, packed):
        assert res.shape == (len(th), nd + 1)
        x, lq = P.flow_sample_logq(flow.spec, flow.params, _t(th))
        np.testing.assert_allclose(res[:, :nd], x.numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res[:, nd], lq.numpy(), rtol=TOL,
                                   atol=TOL)
        # the extra column is the flow density of the drawn row
        np.testing.assert_allclose(res[:, nd],
                                   flow.log_prob(res[:, :nd]).numpy(),
                                   atol=1e-9)
    for i, (tenant, th) in enumerate(jobs):
        with ServeDriver(str(tmp_path / f"alone{i}"),
                         buckets=(1, 8, 16)) as d1:
            d1.register("flow0", flow.serve_view("sample"), width=16)
            rid = d1.submit(tenant, "flow0", th)
            d1.run()
            assert np.array_equal(d1.results[rid], packed[i])


def test_serve_log_prob_mode_scalar_lane(trained, tmp_path):
    flow, _ = trained
    thetas = np.random.default_rng(1).normal([1.0, -2.0], [0.3, 0.7],
                                             size=(6, 2))
    with ServeDriver(str(tmp_path), buckets=(1, 8)) as d:
        d.register("flowq", flow.serve_view("log_prob"), width=8)
        rid = d.submit("t0", "flowq", thetas)
        d.run()
        res = d.results[rid]
    assert res.shape == (6,)
    np.testing.assert_allclose(res, flow.log_prob(thetas).numpy(),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        flow.serve_view("nope")


def _fwn_paramfile(tmp_path, extra=()):
    lines = []
    with open(os.path.join(EXAMPLES, "example_params",
                           "fixed_white_noise.dat")) as fh:
        for line in fh.read().splitlines():
            key, _, val = line.partition(":")
            key = key.strip()
            if key == "datadir":
                line = f"datadir: {os.path.join(EXAMPLES, 'data')}"
            elif key == "out":
                line = f"out: {tmp_path / 'out'}"
            elif key in ("noise_model_file", "noisefiles"):
                line = f"{key}: " + os.path.join(EXAMPLES, val.strip())
            elif line.strip() == "{0}":
                lines += list(extra)
            lines.append(line)
    path = tmp_path / "fwn.dat"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cli_serves_flows_from_the_flag_and_the_paramfile(trained,
                                                          tmp_path,
                                                          capsys):
    flow, _ = trained
    art = str(tmp_path / "flow.npz")
    flow.save(art)
    prfile = _fwn_paramfile(tmp_path, [f"flow_models: f1={art}"])
    rc = cli.main(["serve", "-p", prfile, "--flow", f"f2={art}:log_prob",
                   "--warm", "--synthetic", "24", "--tenants", "4",
                   "--buckets", "1,8,16"], device="cpu")
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["requests_done"] == 24
    assert summary["dropped_requests"] == 0
    assert summary["accounting"]["balanced"]
    with pytest.raises(ValueError, match="NAME=PATH"):
        cli.main(["serve", "-p", prfile, "--flow", "nopath"],
                 device="cpu")


# ------------------------------------------------------- the PT flow family

@pytest.mark.parametrize("kind", ["affine", "rqs"])
def test_propose_flow_matches_the_reference_algebra(kind):
    rspec, tspec, tree = _pair(kind)
    flow = FlowPosterior(tspec, tree, device="cpu")
    rng = np.random.default_rng(12)
    W = 32
    x = 1.5 * rng.standard_normal((W, 5))
    z = rng.standard_normal((W, 5))
    u_ind = rng.uniform(size=W)
    sigma, frac = 0.1, 0.5

    def flow_one(x_w, zf, u):
        u_w, ld_inv_old = R.flow_inverse(rspec, tree, x_w)
        is_ind = u < frac
        u_new = jnp.where(is_ind, zf, u_w + sigma * zf)
        x_new, ld_fwd_new = R.flow_forward(rspec, tree, u_new)
        logq_old = R.base_logpdf(u_w) + ld_inv_old
        logq_new = R.base_logpdf(u_new) - ld_fwd_new
        return x_new, jnp.where(is_ind, logq_old - logq_new,
                                ld_inv_old + ld_fwd_new)
    rp, rq = jax.vmap(flow_one)(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(u_ind))
    tp, tq = propose_flow(_t(x), flow, _t(u_ind), _t(z), sigma, frac)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(rq), rtol=TOL,
                               atol=TOL)


def test_flow_off_is_bit_for_bit_flow_free(trained, tmp_path):
    flow, _ = trained
    like = GaussianLike([1.0, -2.0], [0.3, 0.7])
    chains = []
    for tag, kw in (("none", {}),
                    ("zero", {"flow": flow, "flow_weight": 0})):
        d = str(tmp_path / tag)
        s = PTSampler(like, d, ntemps=2, nchains=8, seed=4,
                      cov_update=200, **kw)
        s.sample(400, resume=False, verbose=False)
        chains.append(np.loadtxt(f"{d}/chain_1.txt"))
        assert s.fam_propose[8] == 0
    assert np.array_equal(chains[0], chains[1])


def test_flow_family_exact_and_attributed(tmp_path):
    # a chain leaning hard on the flow family lands on the posterior of
    # the default families (the MH correction is exact), with the 9-wide
    # attribution crediting family 8 (the reference test's bounds)
    assert _FAM_NAMES[8] == "flow"
    mu, sigma = [1.0, -2.0], [0.3, 0.7]
    flow, _ = _trained_flow(mu=mu, sigma=sigma, steps=400)
    like = GaussianLike(mu, sigma)
    d_def = str(tmp_path / "default")
    s0 = PTSampler(like, d_def, ntemps=2, nchains=16, seed=6,
                   cov_update=300)
    s0.sample(2000, resume=False, verbose=False)
    post0 = np.loadtxt(f"{d_def}/chain_1.txt")[500:, :2]
    d_fl = str(tmp_path / "flow")
    s1 = PTSampler(like, d_fl, ntemps=2, nchains=16, seed=6,
                   cov_update=300, flow=flow, flow_weight=60,
                   scam_weight=10, am_weight=10, de_weight=20)
    s1.sample(2000, resume=False, verbose=False)
    post1 = np.loadtxt(f"{d_fl}/chain_1.txt")[500:, :2]
    assert s1.fam_propose[8] > 500
    assert s1.fam_accept[8] / s1.fam_propose[8] > 0.3
    assert s1.fam_rung_propose.shape == (2, 9)
    assert s1.fam_rung_propose[:, 8].sum() > s1.fam_propose[8]
    np.testing.assert_allclose(post1.mean(0), mu, atol=0.1)
    np.testing.assert_allclose(post1.std(0), sigma, rtol=0.25)
    np.testing.assert_allclose(post1.mean(0), post0.mean(0), atol=0.1)
    np.testing.assert_allclose(post1.std(0), post0.std(0), rtol=0.25)


def test_flow_ndim_mismatch_raises(trained, tmp_path):
    flow, _ = trained                       # a 2-D flow
    like3 = GaussianLike([0.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    with pytest.raises(ValueError):
        PTSampler(like3, str(tmp_path), ntemps=1, nchains=4, seed=0,
                  flow=flow, flow_weight=10)


def test_entry_points_need_a_card_unless_asked(trained, monkeypatch):
    flow, corpus = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    like = GaussianLike([1.0, -2.0], [0.3, 0.7])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_flow(corpus, steps=1, block=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowPosterior(flow.spec, flow.params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rescore_flow(flow, like, n=8)


# ---- on the card: the CUDA graphs against the eager passes ------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py phase 14 runs the "
                    "graphed fit and flow family on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["affine", "rqs"])
def test_cuda_graphed_passes_match_eager(cuda, kind):
    _, tspec, tree = _pair(kind)
    flow = FlowPosterior(tspec, tree, device=cuda)
    rng = np.random.default_rng(13)
    args = [torch.as_tensor(a, device=cuda) for a in (
        1.5 * rng.standard_normal((32, 5)), rng.uniform(size=32),
        rng.standard_normal((32, 5)))]

    def prop(x, u, z):
        return propose_flow(x, flow, u, z)
    graphed = P.cuda_graphed(prop, *args)
    for _ in range(2):
        for a, b in zip(graphed(*args), prop(*args)):
            assert torch.equal(a, b)
        args = [a.flip(0) for a in args]
    for mode in ("sample", "log_prob"):
        sv = flow.serve_view(mode)
        first = sv.loglike_batch(args[0])
        assert torch.equal(first, sv._evaluate(args[0]))
        assert torch.equal(sv.loglike_batch(args[0].flip(0)),
                           sv._evaluate(args[0].flip(0)))
        assert torch.equal(first, sv._evaluate(args[0]))
