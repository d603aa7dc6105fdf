import os

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS says
# otherwise; the GPU path is exercised by chip_smoke.py and by the tests
# marked `gpu` (run them on the card with JAX_PLATFORMS=cuda,cpu), which
# skip without one.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

EXAMPLES = "/root/reference/examples"

# Oracle intermediates from the reference binary: a freshly generated run
# in .tmp/oracle takes precedence (full DBs); the committed fixture set
# (tests/fixtures/oracle, trimmed to what the parity tests read) makes
# the parity suite run by default on a clean checkout.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE_ORACLE = os.path.join(_REPO, "tests", "fixtures", "oracle")
_TMP_ORACLE = os.path.join(_REPO, ".tmp", "oracle")


def oracle_root() -> str:
    # a freshly generated reference run overrides the trimmed committed
    # fixtures (ADVICE r2) — but only when it is COMPLETE, so a partial
    # scratch run cannot shadow fixture resources it lacks
    need = ("profiles.index", os.path.join("nucl", "nuclres.index"),
            os.path.join("orfs", "uvig_orfs.index"),
            os.path.join("uvig", "genome.index"))
    if all(os.path.exists(os.path.join(_TMP_ORACLE, n)) for n in need):
        return _TMP_ORACLE
    return _FIXTURE_ORACLE


@pytest.fixture(scope="session")
def examples_dir():
    return EXAMPLES


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips (inside the `gpu_device` "
        "fixture) where JAX finds none")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided here, at run time, never at
    import or collection, so every xdist worker collects the same
    tests."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU: the CUDA kernel runs only on the card")
    return gpus[0]
