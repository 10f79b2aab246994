"""PyTorch port: the multi-world trigger against the benchmark's plain
reference of the kidnap deployment (port_bench/reference/worlds.py).

A 400-node session with three VIO losses (port_bench/tests/worlds_drive.py)
is ingested into a GraphStore and the port's SolverEngine triggered on the
CPU at five cuts: a first solve in which two worlds meet (case 4) and a
third keeps its own prior, a merge that re-bases a solved world (case 1),
a poll refused while kidnapped, a new world merging on its first trigger
(case 4), and a warm solve. At each solve the engine's guesses equal the
reference's start to 1e-9, its priors and masks are the reference's, and
its answer's cost is within the configuration's limits of the reference's
float64 solve from the same start."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.tests import worlds_drive  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: F401,E402


@pytest.fixture(scope="module")
def rows(one_torch_thread):  # noqa: F811
    return worlds_drive.drive()


def test_each_solve_answers_as_the_worlds_reference(rows):
    solved = [r for r in rows if r["stats"] is not None]
    assert [r["cut"] for r in solved] == [230, 305, 380, 400]
    assert all(r["faults"] == [] for r in solved), [
        (r["cut"], r["faults"]) for r in solved]


def test_the_rows_count_the_worlds_the_session_implies(rows):
    first, rebase, refused, merge, warm = rows
    st = first["stats"]
    assert (st["worlds"], st["sets"], st["priors"], st["first_contacts"],
            st["rebased_nodes"], st["mapped_nodes"], st["dead_nodes"]) == (
        3, 2, 2, 1, 0, 110, 60)
    st = rebase["stats"]
    assert (st["sets"], st["priors"], st["first_contacts"],
            st["rebased_nodes"], st["mapped_nodes"]) == (1, 1, 1, 40, 0)
    assert refused["stats"] is None and refused["kidnap_polls"] == 1
    st = merge["stats"]
    assert (st["worlds"], st["first_contacts"], st["rebased_nodes"],
            st["mapped_nodes"], st["dead_nodes"]) == (4, 1, 0, 40, 90)
    st = warm["stats"]
    assert (st["first_contacts"], st["rebased_nodes"],
            st["mapped_nodes"]) == (0, 0, 0)
    store = warm["store"]
    assert store.n_worlds() == 4 and store.worlds.n_sets() == 1
