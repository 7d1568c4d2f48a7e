"""The check that the port's config of an architecture equals the JAX
package's, shared by the port's family tests."""
import dataclasses


def assert_config_matches_reference(j, t) -> None:
    """The port's config ``t`` against the JAX package's ``j``: every field
    of ``j`` equal and in the same order at the head of ``t``, and each field
    that only the port has (Granite's multipliers, NoPE) at its default."""
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert list(td)[:len(jd)] == list(jd)
    for field in jd:
        assert td[field] == jd[field], field
    own = {f.name: f.default for f in dataclasses.fields(t) if f.name not in jd}
    assert own and {n: td[n] for n in own} == own
