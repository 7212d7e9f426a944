import os
import sys

# smoke tests and benches must see ONE device — the 512-device flag is set
# only inside repro/launch/dryrun.py (see the brief).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from repro.config import override  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import build_model  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test "
        "without one")


@pytest.fixture(scope="session")
def qwen_smoke():
    """A tiny trained-ish dense model shared across conversion tests."""
    cfg = override(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


def make_batch(cfg, batch=2, seq=32, seed=1):
    out = {"tokens": jax.random.randint(jax.random.PRNGKey(seed),
                                        (batch, seq), 0, cfg.vocab_size)}
    if cfg.family == "audio":
        out["frames"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1),
            (batch, cfg.encoder.num_frames, cfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        out["patches"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1),
            (batch, cfg.vision.num_patches, cfg.d_model), jnp.float32)
    return out
