"""The port's ``.env`` loader (``progen_tpu_torch/utils/env.py``): the
cases of ``tests/test_env.py`` against the port's copy, and every parse
held against the JAX package's loader on the same file."""

import os
from pathlib import Path

import pytest

from progen_tpu.utils.env import load_env_file as jax_load_env_file
from progen_tpu_torch.utils.env import load_env_file

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def clean_environ():
    """The loader writes os.environ through setdefault: restore every key
    it added."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _both(path) -> tuple:
    """(port's parse, JAX's parse) of one file, each from the same
    starting environment."""
    saved = dict(os.environ)
    try:
        port = load_env_file(str(path))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    try:
        ref = jax_load_env_file(str(path))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return port, ref


def test_parse_and_precedence(tmp_path, monkeypatch, clean_environ):
    f = tmp_path / ".env"
    f.write_text("# comment\n"
                 "export FOO=bar\n"
                 "QUOTED='a b c'\n"
                 "INLINE=x # trailing comment\n"
                 "WINS=dotenv\n")
    monkeypatch.setenv("WINS", "environ")
    parsed = load_env_file(str(f))
    assert parsed["FOO"] == "bar" and os.environ["FOO"] == "bar"
    assert parsed["QUOTED"] == "a b c"
    assert parsed["INLINE"] == "x"
    # the existing environment wins (dotenv's override=False)
    assert os.environ["WINS"] == "environ"
    assert _both(f)[0] == _both(f)[1]


def test_missing_file():
    assert load_env_file("/nonexistent/.env") == {}
    assert jax_load_env_file("/nonexistent/.env") == {}


def test_dotenv_dir_expansion(tmp_path):
    f = tmp_path / ".env"
    f.write_text("CACHE=${DOTENV_DIR}/runs/cache\n")
    port, ref = _both(f)
    assert port["CACHE"] == str(tmp_path.resolve() / "runs/cache")
    assert port == ref


def test_upward_search(tmp_path, monkeypatch, clean_environ):
    (tmp_path / ".env").write_text("UPWARD_FOUND=yes\n")
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    monkeypatch.chdir(sub)
    assert load_env_file()["UPWARD_FOUND"] == "yes"


@pytest.mark.parametrize("text", [
    "A=1\nB = two \n",
    "export X='quoted # not a comment'\nY=\"dq\"\n",
    "BAD LINE\nK=v\tv # c\n",
    "EMPTY=\nTABBED=v\t# comment\n",
])
def test_parses_like_the_jax_loader(tmp_path, text):
    f = tmp_path / ".env"
    f.write_text(text)
    port, ref = _both(f)
    assert port == ref


def test_shipped_env_parses_as_the_jax_loader_does():
    env_path = REPO_ROOT / ".env"
    assert env_path.exists()
    port, ref = _both(env_path)
    assert port and port == ref
