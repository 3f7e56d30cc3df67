"""Concrete EVM core: the SoA frontier and the vectorized interpreter."""

from .frontier import Frontier, Env, Corpus, make_frontier, make_env  # noqa: F401
from .interpreter import superstep, run  # noqa: F401
