"""Synthesis loop and matchers of the port."""

from .matcher import Matcher, get_matcher, register_matcher
from .brute import BruteForceMatcher, exact_nn
from .ann import AnnMatcher
from .patchmatch import PatchMatchMatcher, patchmatch_sweeps, random_init
from .coherence import CoherenceWrapper, coherence_sweeps
from .analogy import (
    LevelState,
    create_image_analogy,
    load_level_state,
    upsample_nnf,
)

__all__ = [
    "AnnMatcher",
    "BruteForceMatcher",
    "CoherenceWrapper",
    "LevelState",
    "Matcher",
    "PatchMatchMatcher",
    "coherence_sweeps",
    "create_image_analogy",
    "exact_nn",
    "get_matcher",
    "load_level_state",
    "patchmatch_sweeps",
    "random_init",
    "register_matcher",
    "upsample_nnf",
]
