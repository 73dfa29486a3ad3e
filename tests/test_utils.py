"""In-repo helpers: the frozen-dataclass pytree and the compile-cache switch."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ndtpso_slam
from ndtpso_slam.utils import compile_cache
from ndtpso_slam.utils.pytree import PyTreeNode, field


class _Node(PyTreeNode):
    a: jnp.ndarray
    b: jnp.ndarray
    radius: int = field(static=True, default=2)


def test_pytree_node_leaves_replace_and_frozen():
    n = _Node(a=jnp.ones(3), b=jnp.zeros(2))
    assert [x.shape for x in jax.tree_util.tree_leaves(n)] == [(3,), (2,)]
    m = n.replace(b=jnp.full(2, 7.0))
    np.testing.assert_array_equal(np.asarray(m.b), [7.0, 7.0])
    np.testing.assert_array_equal(np.asarray(n.b), [0.0, 0.0])  # copy
    assert m.radius == 2
    with pytest.raises(AttributeError):
        n.a = jnp.zeros(3)
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, n)
    assert isinstance(doubled, _Node) and doubled.radius == 2


def test_pytree_static_field_is_part_of_the_treedef():
    """A static field is hashed into the treedef, never traced: jit sees it
    as a Python int and retraces when it changes."""
    traced = []

    @jax.jit
    def f(n):
        traced.append(type(n.radius))
        return n.a * n.radius

    n = _Node(a=jnp.ones(2), b=jnp.ones(1), radius=3)
    np.testing.assert_array_equal(np.asarray(f(n)), [3.0, 3.0])
    f(n.replace(a=jnp.zeros(2)))  # same treedef: no retrace
    assert traced == [int]
    np.testing.assert_array_equal(np.asarray(f(n.replace(radius=5))), [5.0, 5.0])
    assert traced == [int, int]
    assert jax.tree_util.tree_structure(n) != jax.tree_util.tree_structure(
        n.replace(radius=5)
    )


def test_compile_cache_honors_the_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing is set


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path.endswith(".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(ndtpso_slam.__file__)))
    assert path == os.path.join(checkout, ".jax_cache")
