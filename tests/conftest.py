"""Test configuration.

By default every test runs on a virtual 8-device CPU mesh: the platform
and XLA flags are set before JAX initializes a backend.  A process that
already drives a GPU (chip_smoke.py runs the `gpu`-marked tests
in-process, because a second JAX process cannot reserve the card's
memory) sets NORI_TESTS_ON_DEVICE=1 first, and the pinning is left out.
Collection is the same either way: whether a card is present is decided
only inside the `gpu` fixture.
"""

import os

if not os.environ.get("NORI_TESTS_ON_DEVICE"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REF_SCENES = "/root/reference/scenes"


@pytest.fixture(scope="session")
def ref_scenes():
    if not os.path.isdir(REF_SCENES):
        pytest.skip("reference scenes not available")
    return REF_SCENES


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
