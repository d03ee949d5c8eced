"""PyTorch port: serving on the CPU, against the JAX package's Predictor.

The tiny GAViKO geometry runs in fp32 through the plain versions; the JAX
params go to both predictors as one .npz checkpoint. The HTTP surface is
checked as tests/test_serving.py checks the JAX package's.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from gaviko_tpu.models.factory import build_model as jax_build_model
from gaviko_tpu.serving import Predictor as JaxPredictor
from gaviko_tpu_torch.serving import BatchQueue, Predictor, serve
from gaviko_tpu_torch.weights.torch_io import load_checkpoint

MODEL = dict(image_size=32, image_patch_size=16, frames=24, frame_patch_size=12,
             num_classes=5, channels=1, pool="cls", backbone="vit-s16",
             method="gaviko", freeze_vit=True, num_prompts=4,
             prompt_latent_dim=8, local_dim=8, local_k=[2, 2, 2])
CONFIG = {"model": MODEL}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jm = jax_build_model(MODEL)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3), jm.spec).items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "full.npz")
    np.savez(path, **params)
    return path


@pytest.fixture(scope="module")
def predictor(ckpt):
    return Predictor(CONFIG, checkpoint=ckpt, batch_size=2, dtype="float32",
                     pretrained_dir=None, device="cpu")


def _vols(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(24, 32, 32).astype(np.float32) for _ in range(n)]


def _npz(vol) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, data=vol)
    return buf.getvalue()


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server.server_address[1]


def test_logits_match_jax_predictor(predictor, ckpt):
    jp = JaxPredictor(CONFIG, checkpoint=ckpt, batch_size=2, dtype="float32",
                      pretrained_dir=None)
    vols = _vols(3, 0)  # two micro-batches, the second one padded
    got = predictor.predict_logits(vols)
    want = jp.predict_logits(vols)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (predictor.predict(vols) == got.argmax(-1)).all()


def test_predictor_rejects_unported_options(ckpt):
    """mesh_shape needs a process group of exactly data x tp ranks (served
    on a mesh by tests/test_torch_parallel_run.py), so one process refuses
    (2, 2) naming the launcher; quantize takes None or "int8" only, as in
    the JAX package (int8 itself is served by tests/test_torch_int8.py)."""
    with pytest.raises(RuntimeError, match="exactly 4 ranks.*torchrun"):
        Predictor(CONFIG, checkpoint=ckpt, pretrained_dir=None, device="cpu",
                  mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="quantize"):
        Predictor(CONFIG, checkpoint=ckpt, pretrained_dir=None, device="cpu", quantize="int4")


def test_missing_timm_file_warns_and_continues(tmp_path, caplog):
    p = Predictor(CONFIG, batch_size=1, dtype="float32", pretrained_dir=str(tmp_path),
                  device="cpu")
    assert "continuing with random init" in caplog.text
    assert p.predict_logits(_vols(1, 1)).shape == (1, 5)


def test_present_timm_file_is_not_silently_ignored(tmp_path):
    """A timm file in ``pretrained_dir`` is converted and lands in the
    Predictor's params (its first block and the embeddings here), as the
    JAX package's ``weights/convert.py`` converts it."""
    from gaviko_tpu.weights.convert import convert_timm_state

    rng = np.random.RandomState(0)
    d = 384
    timm = {"cls_token": rng.randn(1, 1, d), "pos_embed": rng.randn(1, 197, d),
            "patch_embed.proj.weight": rng.randn(d, 3, 16, 16),
            "patch_embed.proj.bias": rng.randn(d), "norm.weight": rng.randn(d),
            "norm.bias": rng.randn(d), "blocks.0.norm1.weight": rng.randn(d),
            "blocks.0.attn.qkv.weight": rng.randn(3 * d, d),
            "blocks.0.attn.qkv.bias": rng.randn(3 * d),
            "blocks.0.mlp.fc2.weight": rng.randn(d, 4 * d)}
    timm = {k: v.astype(np.float32) for k, v in timm.items()}
    np.savez(tmp_path / "vit_small_patch16_224_in21k.npz", **timm)
    p = Predictor(CONFIG, batch_size=1, dtype="float32", pretrained_dir=str(tmp_path),
                  device="cpu")
    want = convert_timm_state(timm, num_patches=8, depth_dim=12)
    landed = [k for k in want if k in p.params]
    assert sorted(set(want) - set(landed)) == ["transformer.attns.0.to_qkv.bias"]
    for k in landed:
        np.testing.assert_array_equal(p.params[k].numpy(), want[k], err_msg=k)
    assert p.predict_logits(_vols(1, 1)).shape == (1, 5)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_checkpoint_bf16(tmp_path, fmt):
    import jax.numpy as jnp

    vals = [1.5, -2.25, 3.0]
    path = str(tmp_path / f"c.{fmt}")
    if fmt == "npz":
        np.savez(path, w=np.asarray(jnp.asarray(vals, jnp.bfloat16)))
    else:
        torch.save({"w": torch.tensor(vals, dtype=torch.bfloat16)}, path)
    w = load_checkpoint(path)["w"]
    assert w.dtype == torch.bfloat16 and w.float().tolist() == vals


def test_reload_checkpoint_swaps_weights(predictor, tmp_path):
    vols = _vols(1, 2)
    before = predictor.predict_logits(vols)
    shift = np.arange(5, dtype=np.float32)
    # Overlays land on the seed's initial weights, so carry every entry.
    state = {k: v.clone() for k, v in predictor.params.items()}
    state["mlp_head.head.bias"] += torch.from_numpy(shift)
    path = str(tmp_path / "overlay.pt")
    torch.save(state, path)
    old = predictor.params
    try:
        predictor.reload_checkpoint(path)
        assert predictor.params is not old
        np.testing.assert_allclose(predictor.predict_logits(vols) - before, shift[None],
                                   atol=1e-4)
    finally:
        predictor.params = old


def test_predict_snapshots_params_across_chunks(predictor):
    vols = _vols(4, 3)  # two chunks
    want = predictor.predict_logits(vols)
    old_params, real = predictor.params, predictor._forward
    calls = {"n": 0}

    def hijack(params, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            predictor.params = "poisoned"  # a reload landing between chunks
        assert params is old_params, "chunk used post-reload params"
        return real(params, batch)

    predictor._forward = hijack
    try:
        got = predictor.predict_logits(vols)
    finally:
        del predictor._forward
        predictor.params = old_params
    assert calls["n"] == 2
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_http_predict_healthz_and_bad_body(predictor):
    server = serve(predictor, port=0)
    port = _start(server)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.load(r)["status"] == "ok"
        vol = _vols(1, 4)[0]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=_npz(vol), method="POST")
        with urllib.request.urlopen(req) as r:
            out = json.load(r)
        np.testing.assert_allclose(out["logits"], predictor.predict_logits([vol])[0],
                                   atol=1e-5)
        assert 0 <= out["class"] < 5
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=b"not-an-npz", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(bad)
        assert exc.value.code == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            m = json.load(r)
        assert m["requests_total"] >= 1 and m["batches_total"] >= 1
        assert m["latency_p50_ms"] > 0
        assert 0 < m["mean_batch_occupancy"] <= predictor.batch_size
    finally:
        server.shutdown()
        server.server_close()
    assert not server.batcher._thread.is_alive()


def test_http_auth_body_cap_and_reload_dir(predictor, tmp_path):
    allowed = tmp_path / "ckpts"
    allowed.mkdir()
    server = serve(predictor, port=0, auth_token="s3cret", max_body_bytes=1024,
                   checkpoint_dir=str(allowed))
    port = _start(server)
    url = f"http://127.0.0.1:{port}"
    body = _npz(_vols(1, 5)[0])
    try:
        cases = [
            (f"{url}/predict", body, {}, 401),
            (f"{url}/predict", body, {"Authorization": "Bearer s3cret"}, 413),
            (f"{url}/reload", b"{}", {"Authorization": "Bearer wrong"}, 401),
            (f"{url}/reload", json.dumps({"checkpoint": "/etc/passwd"}).encode(),
             {"Authorization": "Bearer s3cret"}, 403),
        ]
        for target, data, headers, code in cases:
            req = urllib.request.Request(target, data=data, method="POST",
                                         headers=headers)
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req)
            assert exc.value.code == code, (target, headers)
        with urllib.request.urlopen(f"{url}/healthz") as r:  # GETs stay open
            assert json.load(r)["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()


def test_batch_queue_coalesces(predictor):
    calls = []
    orig = predictor.predict_logits

    def counting(vols):
        calls.append(len(vols))
        return orig(vols)

    predictor.predict_logits = counting
    bq = BatchQueue(predictor, max_wait_ms=500.0)
    try:
        vols = _vols(2, 6)
        results = [None, None]

        def worker(i):
            results[i] = bq.submit(vols[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        want = orig(vols)
        for i in range(2):
            np.testing.assert_allclose(results[i], want[i], atol=1e-5)
        assert calls == [2], calls
    finally:
        del predictor.predict_logits
        bq.close()


def test_batch_queue_propagates_errors(predictor):
    predictor.predict_logits = lambda vols: (_ for _ in ()).throw(ValueError("boom"))
    bq = BatchQueue(predictor, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            bq.submit(np.zeros((24, 32, 32), np.float32))
    finally:
        del predictor.predict_logits
        bq.close()
