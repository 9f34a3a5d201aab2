"""Per-workload recipes (example/settings.txt equivalents)."""

import pytest

from manisdp import recipes
from manisdp.config import merged_options


def test_all_recipes_resolve_to_valid_options():
    for wl in recipes.RECIPES:
        variant, ov = recipes.recipe(wl)
        opt = merged_options(variant, **ov)
        assert opt.tol > 0 and opt.tr_maxiter >= 1


def test_size_conditionals():
    _, qs_small = recipes.recipe("qs", size=50)
    _, qs_large = recipes.recipe("qs", size=60)
    assert qs_small["sigma0"] == 1.0 and qs_large["sigma0"] == 1e-2
    _, bqp_small = recipes.recipe("bqp", size=10)
    _, bqp_large = recipes.recipe("bqp", size=11)
    assert bqp_small["tr_maxinner"] == 20
    assert bqp_large["tr_maxinner"] == 25


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        recipes.recipe("nope")


def test_recipe_dicts_are_copies():
    _, a = recipes.recipe("mc")
    a["sigma0"] = 123.0
    _, b = recipes.recipe("mc")
    assert b["sigma0"] != 123.0
