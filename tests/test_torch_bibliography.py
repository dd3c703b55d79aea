"""The port's bibliography and ``list_modules`` against the JAX package's,
on the CPU: ``process_citations`` in all three styles, ``bibtex_entry`` and
``text_entry`` for every key (and an unknown one), and the whole
``list_modules`` dump per citation style, byte for byte."""

import contextlib
import io

import pytest

from libpointmatcher_tpu import bibliography as jb
from libpointmatcher_tpu.apps import list_modules as j_list

from libpointmatcher_tpu_torch import bibliography as tb
from libpointmatcher_tpu_torch.apps import list_modules as t_list

STYLES = ("normal", "roswiki", "bibtex")
KEYS = sorted(jb.BIBLIOGRAPHY) + ["NoSuchKey2000"]


def test_entries_equal_jax():
    assert tb.BIBLIOGRAPHY == jb.BIBLIOGRAPHY
    assert list(tb.BIBLIOGRAPHY) == list(jb.BIBLIOGRAPHY)


@pytest.mark.parametrize("key", KEYS)
def test_entry_renderings_equal_jax(key):
    assert tb.bibtex_entry(key) == jb.bibtex_entry(key)
    assert tb.text_entry(key) == jb.text_entry(key)


@pytest.mark.parametrize("style", STYLES)
def test_process_citations_equal_jax(style):
    text = ("ICP \\cite{Besl1992Point2Point} and planes \\cite{Chen1991Point2Plane}, "
            "again \\cite{Besl1992Point2Point}, unknown \\cite{NoSuchKey2000}.")
    out = tb.process_citations(text, style)
    assert out == jb.process_citations(text, style)
    assert out[0].count("[1]") == 2 and out[1][-1] == "NoSuchKey2000"


def _dump(main, style):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--citationStyle", style]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("style", STYLES)
def test_list_modules_dump_equals_jax(style):
    out = _dump(t_list.main, style)
    assert out == _dump(j_list.main, style)
    for section in ("Transformations", "DataPointsFilters", "Matchers",
                    "OutlierFilters", "ErrorMinimizers", "TransformationCheckers",
                    "Inspectors", "Loggers", "Bibliography"):
        assert f"\n{section}\n" in out
    assert ("@inproceedings{" in out) == (style == "bibtex")
