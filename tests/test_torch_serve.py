"""The port's image server against the reference's.

  * Account-only at VGG16/224 (full width) and ResNet-20/32: the port's
    ledger summary equals the reference's field for field, exactly, on
    the same request trace and the same virtual clock.
  * Computing on the CPU (the plain version): every rid is answered
    once, and the logits equal the reference lax server's for the same
    requests (max |port - ref| <= 1e-4 * max |ref|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import init_resnet as jax_init_resnet
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import resnet_graph as jax_resnet_graph
from repro.serve import AdmissionQueue as JaxAdmissionQueue
from repro.serve import ImageRequest as JaxImageRequest
from repro.serve import ImageServer as JaxImageServer
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve_images
from repro_torch.models.cnn import init_vgg, resnet_graph, vgg_graph
from repro_torch.models.graph import graph_logits
from repro_torch.serve import AdmissionQueue, ImageRequest, ImageServer

_FIELDS = ("requests", "images", "dispatches", "padded_images",
           "bytes_per_image", "weight_bytes_per_image", "vs_bound_x",
           "w_amortization_x", "vs_serving_x", "by_model")


def _numpy_tree(params):
    return {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"])}


def _drive(srv, sizes, payloads=None):
    """Submit the whole trace at virtual time 0, polling after each
    submit (only maximal groups leave before the wait budget), then
    drain; returns the results in rid order."""
    out = []
    for i, n in enumerate(sizes):
        if payloads is None:
            srv.submit(n_images=int(n), now=0.0)
        else:
            srv.submit(payloads[i], now=0.0)
        out += srv.poll(now=0.0)
    out += srv.drain(now=0.0)
    return sorted(out, key=lambda r: r.rid)


@pytest.fixture(scope="module")
def full_vgg():
    ref = jax_init_vgg(jax.random.PRNGKey(0))
    return ref, init_vgg(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("sizes", [
    (2, 2, 2, 2),                                 # 4 requests x 2 images
    tuple(np.random.default_rng(0).integers(1, 9, size=16)),
    (1, 3, 8, 5, 2, 2, 7, 1),
])
def test_account_only_vgg16_ledger_equals_reference(full_vgg, sizes):
    ref_params, params = full_vgg
    t = [0.0]
    ref_srv = JaxImageServer(ref_params, 224, 224, compute=False,
                             clock=lambda: t[0])
    srv = ImageServer(params, 224, 224, target="account-only",
                      device="cpu", clock=lambda: t[0])
    _drive(ref_srv, sizes)
    _drive(srv, sizes)
    got, ref = srv.ledger.summary(), ref_srv.ledger.summary()
    for f in _FIELDS:
        assert got[f] == ref[f], f
    if sizes == (2, 2, 2, 2):
        assert got["bytes_per_image"] == 143414256.0


def test_account_only_resnet_ledger_equals_reference():
    sizes = (3, 1, 4, 4, 2, 8, 1, 6)
    t = [0.0]
    ref_graph = jax_resnet_graph()
    ref_srv = JaxImageServer(jax_init_resnet(jax.random.PRNGKey(0),
                                             ref_graph), 32, 32,
                             graph=ref_graph, compute=False,
                             clock=lambda: t[0])
    graph = resnet_graph()
    srv = ImageServer({"convs": [], "head": None}, 32, 32, graph=graph,
                      target="account-only", device="cpu",
                      clock=lambda: t[0])
    _drive(ref_srv, sizes)
    _drive(srv, sizes)
    got, ref = srv.ledger.summary(), ref_srv.ledger.summary()
    for f in _FIELDS:
        assert got[f] == ref[f], f


def test_compute_server_matches_reference_lax_server():
    ref_params = jax_init_vgg(jax.random.PRNGKey(1), width_mult=1 / 16)
    params = params_from_numpy(_numpy_tree(ref_params), device="cpu")
    sizes = (1, 3, 2, 4, 1)
    rng = np.random.default_rng(1)
    payloads = [rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
                for n in sizes]
    t = [0.0]
    ref_srv = JaxImageServer(ref_params, 32, 32, buckets=(1, 2, 4),
                             target="lax", clock=lambda: t[0])
    srv = ImageServer(params, 32, 32, buckets=(1, 2, 4), device="cpu",
                      clock=lambda: t[0])
    ref = _drive(ref_srv, sizes, payloads)
    got = _drive(srv, sizes, payloads)
    assert [r.rid for r in got] == list(range(len(sizes)))
    assert [r.rid for r in got] == [r.rid for r in ref]
    for g, r in zip(got, ref):
        rl = np.asarray(r.logits)
        assert tuple(g.logits.shape) == rl.shape
        err = np.abs(g.logits.numpy() - rl).max()
        assert err <= 1e-4 * np.abs(rl).max(), (g.rid, err)
        assert dataclasses.asdict(g.charge) == dataclasses.asdict(r.charge)
    assert srv.stats["traces"] == len({r.charge.bucket for r in got})
    assert srv.stats["dispatches"] == ref_srv.stats["dispatches"]


@pytest.mark.parametrize("sizes,buckets,now", [
    ((1, 2, 1), (1, 2, 4), 0.0),
    ((3, 3, 3), (1, 2, 4, 8), 0.0),
    ((1, 1), (1, 2, 4), 0.5),
    ((5, 4, 8, 1, 1), (1, 2, 4, 8), 0.01),
])
def test_admission_equals_reference(sizes, buckets, now):
    groups = []
    for queue_cls, req_cls in ((AdmissionQueue, ImageRequest),
                               (JaxAdmissionQueue, JaxImageRequest)):
        q = queue_cls(buckets, wait_budget=0.1)
        for rid, n in enumerate(sizes):
            q.submit(req_cls(rid=rid, n_images=n, arrival=0.0))
        got = []
        while (ready := q.pop_ready(now)) is not None:
            got.append(([r.rid for r in ready[0]], ready[1]))
        got += [([r.rid for r in g], b) for g, b in q.drain()]
        groups.append(got)
    assert groups[0] == groups[1]


def test_submit_rejects_wrong_geometry_and_missing_payload():
    params = init_vgg(torch.Generator().manual_seed(0), width_mult=1 / 16,
                      device="cpu")
    srv = ImageServer(params, 16, 16, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        srv.submit(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="payload"):
        srv.submit(n_images=2)


def test_launch_cli_account_only(capsys):
    serve_images.main(["--account-only", "--device", "cpu",
                       "--requests", "4"])
    out = capsys.readouterr().out
    assert "ledger: 4 req" in out and "vs Eq.(15) bound" in out


def test_launch_cli_computes_resnet_on_cpu(capsys):
    serve_images.main(["--model", "resnet", "--device", "cpu",
                       "--width-mult", "0.25", "--image", "16",
                       "--requests", "3", "--buckets", "1", "2", "4",
                       "8"])
    out = capsys.readouterr().out
    assert "ledger: 3 req" in out and "[resnet20]" in out


def test_ledger_accounts_bf16_serving_equals_reference():
    """The mirror of the reference's ``test_ledger_accounts_bf16_serving``:
    a bf16 server charges 2-byte words, and every charge and summary
    field equals the reference's, byte for byte, in both types."""
    ref_params = jax_init_vgg(jax.random.PRNGKey(0), n_classes=4,
                              width_mult=0.05)
    params = init_vgg(torch.Generator().manual_seed(0), n_classes=4,
                      width_mult=0.05, device="cpu")
    charges = {}
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        t = [0.0]
        ref_srv = JaxImageServer(ref_params, 8, 8, compute=False,
                                 dtype=jdtype, clock=lambda: t[0],
                                 wait_budget=0.0)
        srv = ImageServer(params, 8, 8, target="account-only",
                          device="cpu", dtype=dtype, clock=lambda: t[0],
                          wait_budget=0.0)
        for s in (ref_srv, srv):
            s.submit(n_images=4, now=0.0)
        (ref,) = ref_srv.poll(now=0.0)
        (res,) = srv.poll(now=0.0)
        words = sum(p.traffic(4).total for _, p in srv.plan_handles(4))
        assert res.charge.bytes_total == words * dtype.itemsize
        assert dataclasses.asdict(res.charge) == dataclasses.asdict(
            ref.charge)
        got, want = srv.ledger.summary(), ref_srv.ledger.summary()
        for f in _FIELDS:
            assert got[f] == want[f], f
        charges[dtype] = res.charge
    assert (charges[torch.bfloat16].bytes_total * 2
            == charges[torch.float32].bytes_total)


def test_bf16_sizes_equal_reference_at_full_width(full_vgg):
    """VGG16/224 account-only in bf16 over a mixed trace: the ledger
    equals the reference's field for field."""
    ref_params, params = full_vgg
    sizes = (1, 3, 8, 5, 2, 2, 7, 1)
    t = [0.0]
    ref_srv = JaxImageServer(ref_params, 224, 224, compute=False,
                             dtype=jnp.bfloat16, clock=lambda: t[0])
    srv = ImageServer(params, 224, 224, target="account-only",
                      device="cpu", dtype=torch.bfloat16,
                      clock=lambda: t[0])
    _drive(ref_srv, sizes)
    _drive(srv, sizes)
    got, ref = srv.ledger.summary(), ref_srv.ledger.summary()
    for f in _FIELDS:
        assert got[f] == ref[f], f


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_computing_bf16_server_raises_at_construction(device):
    """A computing server runs K1 in float32 or bfloat16.  A bf16
    server constructs and serves bf16 logits (on the CPU here; a cuda
    request on a host without a card raises for the device, never for
    the type); a type K1 does not take (float16) still raises at
    construction, naming K1's types, before any device is touched."""
    params = init_vgg(torch.Generator().manual_seed(0), n_classes=4,
                      width_mult=0.05, device="cpu")
    with pytest.raises(ValueError, match="takes float32 or bfloat16"):
        ImageServer(params, 8, 8, dtype=torch.float16, device=device)
    if device == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImageServer(params, 8, 8, dtype=torch.bfloat16, device=device)
        return
    bf16 = {"convs": [{k: t.to(device, torch.bfloat16)
                       for k, t in p.items()} for p in params["convs"]],
            "head": params["head"].to(device, torch.bfloat16)}
    t = [0.0]
    srv = ImageServer(bf16, 8, 8, dtype=torch.bfloat16, device=device,
                      buckets=(1, 2), clock=lambda: t[0])
    imgs = np.random.default_rng(4).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    (res,) = _drive(srv, (2,), [imgs])
    assert res.logits.dtype == torch.bfloat16
    assert tuple(res.logits.shape) == (2, 4)
    assert bool(torch.isfinite(res.logits.float()).all())


def test_custom_forward_serves_and_needs_a_graph():
    params = init_vgg(torch.Generator().manual_seed(0), n_classes=4,
                      width_mult=0.05, device="cpu")
    graph = vgg_graph(params)
    seen = []

    def forward(p, imgs, target):
        seen.append((tuple(imgs.shape), target.name))
        return graph_logits(graph, p, imgs.float())

    with pytest.raises(ValueError, match="explicit graph"):
        ImageServer(params, 8, 8, forward=forward, device="cpu")
    t = [0.0]
    srv = ImageServer(params, 8, 8, graph=graph, forward=forward,
                      buckets=(1, 2), device="cpu", clock=lambda: t[0])
    rng = np.random.default_rng(2)
    imgs = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    (res,) = _drive(srv, (2,), [imgs])
    assert seen == [((2, 8, 8, 3), "kernel")]
    want = graph_logits(graph, params, torch.from_numpy(imgs))
    torch.testing.assert_close(res.logits, want)
    # a custom forward may serve bf16: the words it is charged are 2 bytes
    bf = ImageServer(params, 8, 8, graph=graph, forward=forward,
                     buckets=(1, 2), device="cpu", dtype=torch.bfloat16,
                     clock=lambda: t[0])
    (res16,) = _drive(bf, (2,), [imgs])
    assert res16.charge.bytes_total * 2 == res.charge.bytes_total
