"""Shared test configuration.

Provides a deterministic fallback implementation of the small `hypothesis`
subset the suite uses (``given`` / ``settings`` / ``strategies``) when the
real package is not installed, so property tests still run (as bounded
random sweeps with a fixed per-test seed) instead of erroring at collection.
"""

import random
import sys
import types


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess / multi-device)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips without them")


def pytest_addoption(parser):
    parser.addoption(
        "--update-goldens", action="store_true", default=False,
        help="rewrite the tests/goldens/*.json conformance fixtures from "
             "the current pipeline's outputs (then commit the diff)")


def _install_hypothesis_stub():
    try:
        import hypothesis  # noqa: F401
        return
    except ModuleNotFoundError:
        pass

    class _Strategy:
        def __init__(self, sample):
            self._sample = sample

        def example(self, rnd):
            return self._sample(rnd)

    def integers(min_value=0, max_value=2**31 - 1):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: r.choice(elements))

    def booleans():
        return _Strategy(lambda r: bool(r.getrandbits(1)))

    def floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def given(**strategies):
        def decorate(fn):
            import inspect

            takes_self = "self" in inspect.signature(fn).parameters

            def _examples(args):
                n = getattr(runner, "_stub_max_examples", 10)
                rnd = random.Random(fn.__qualname__)
                for _ in range(n):
                    kw = {k: s.example(rnd) for k, s in strategies.items()}
                    fn(*args, **kw)

            # Plain signatures (no *args) so pytest does not mistake the
            # strategy parameters for fixtures.
            if takes_self:
                def runner(self):
                    _examples((self,))
            else:
                def runner():
                    _examples(())
            runner.__name__ = fn.__name__
            runner.__qualname__ = fn.__qualname__
            runner.__module__ = fn.__module__
            runner.__doc__ = fn.__doc__
            return runner

        return decorate

    def settings(max_examples=10, deadline=None, **_):
        def decorate(fn):
            fn._stub_max_examples = max_examples
            return fn

        return decorate

    mod = types.ModuleType("hypothesis")
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.sampled_from = sampled_from
    st_mod.booleans = booleans
    st_mod.floats = floats
    mod.given = given
    mod.settings = settings
    mod.strategies = st_mod
    mod.__stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


_install_hypothesis_stub()
