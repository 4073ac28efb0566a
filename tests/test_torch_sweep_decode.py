"""The decode sweep's variant sources (CPU: builds and times nothing)."""
from paddle_tpu_torch import sweep_decode as sd


def test_source_values_are_the_kernels_constants():
    values = sd.source_values(sd.SOURCE.read_text())
    assert set(values) == set(sd.CONSTANTS)
    for name, value in values.items():
        assert value in sd.VALUES[name], (name, value)


def test_variant_source_sets_only_the_given_constant():
    text = sd.SOURCE.read_text()
    base = sd.source_values(text)
    assert sd.variant_source(text, base) == text
    out = sd.variant_source(text, {"kWarps": 8})
    assert sd.source_values(out) == {**base, "kWarps": 8}
    assert out.replace("kWarps = 8;", f"kWarps = {base['kWarps']};") == text


def test_variants_vary_one_constant_at_a_time():
    base = sd.source_values(sd.SOURCE.read_text())
    order = sd.variants(base)
    assert order[0] == base and order[-1] == base
    for values in order[1:-1]:
        changed = [n for n in sd.CONSTANTS if values[n] != base[n]]
        assert len(changed) == 1, values
    expected = sum(len(v) - 1 for v in sd.VALUES.values())
    assert len(order) == expected + 2
    assert len({sd.tag(v) for v in order}) == expected + 1
