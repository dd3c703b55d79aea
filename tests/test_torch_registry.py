"""The port's module registry against the JAX package's, on the CPU: the
same names in each of the 8 registrars, and for each of the 58 modules the
same ``description()`` and ``available_parameters()`` (name, doc, type,
default, min, max); the introspection (``get_class``, ``has``, ``names``,
``dump``, ``items``) and ``register(name=...)``."""

import pytest

import libpointmatcher_tpu as pm
import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.registry import Parametrizable, Registrar

REGISTRARS = ("TransformationRegistrar", "DataPointsFilterRegistrar",
              "MatcherRegistrar", "OutlierFilterRegistrar",
              "ErrorMinimizerRegistrar", "TransformationCheckerRegistrar",
              "InspectorRegistrar", "LoggerRegistrar")
MODULES = [(r, name) for r in REGISTRARS for name in getattr(pm, r).names()]


def test_module_count():
    assert len(MODULES) == 58


@pytest.mark.parametrize("registrar", REGISTRARS)
def test_registrar_names_equal_jax(registrar):
    jr, tr = getattr(pm, registrar), getattr(pt, registrar)
    assert tr.names() == jr.names()
    assert tr.dump() == jr.dump()
    assert [n for n, _ in tr.items()] == [n for n, _ in jr.items()]
    assert tr.interface_name == jr.interface_name


@pytest.mark.parametrize("registrar,name", MODULES)
def test_module_text_equals_jax(registrar, name):
    jc = getattr(pm, registrar).get_class(name)
    tc = getattr(pt, registrar).get_class(name)
    assert tc.name() == jc.name() == name
    assert tc.description() == jc.description()
    tp, jp = tc.available_parameters(), jc.available_parameters()
    assert [(p.name, p.doc, p.type, p.default, p.min, p.max) for p in tp] == \
        [(p.name, p.doc, p.type, p.default, p.min, p.max) for p in jp]


@pytest.mark.parametrize("registrar", REGISTRARS)
def test_get_class_raises_invalid_element(registrar):
    tr = getattr(pt, registrar)
    assert not tr.has("NoSuchModule")
    with pytest.raises(pt.InvalidElement, match="NoSuchModule"):
        tr.get_class("NoSuchModule")
    for name in tr.names():
        assert tr.has(name) and tr.get_class(name).__name__ == name


def test_register_by_name():
    reg = Registrar("Widget")

    @reg.register(name="Alias")
    class Widget(Parametrizable):
        """A widget."""

    @reg.register
    class Gadget(Parametrizable):
        DESCRIPTION = "a gadget"

    reg.register(Widget)
    assert reg.names() == ["Alias", "Gadget", "Widget"]
    assert reg.get_class("Alias") is Widget and reg.has("Widget")
    assert reg.dump() == "Alias\nGadget\nWidget"
    assert Widget.description() == "A widget." and Gadget.description() == "a gadget"
    assert isinstance(reg.create("Alias"), Widget)
    assert issubclass(pt.InvalidElement, pt.PointMatcherError)
    assert "InvalidElement" in pt.__all__
