"""The reference's own evaluation of specs, held to the standard library's
calendar on every second of a few spans."""

import datetime as dt

import numpy as np

from portbench import gen, reference


def _brute(spec, t):
    sets, dom_star, dow_star = reference.parse_cron(spec)
    out = []
    for s in t:
        d = dt.datetime.fromtimestamp(int(s), dt.timezone.utc)
        f = (d.second, d.minute, d.hour, d.day, d.month, (d.weekday() + 1) % 7)
        ok = [f[i] in sets[i] for i in range(6)]
        day = (ok[3] and ok[5]) if (dom_star or dow_star) else (ok[3] or ok[5])
        out.append(ok[0] and ok[1] and ok[2] and ok[4] and day)
    return np.array(out)


def test_utc_fields_match_the_calendar():
    t = np.array([0, 951782400, 1753000020, 1767225599, 4102444799,
                  1709164800, 1709251199])
    got = np.stack(reference.utc_fields(t), 1)
    for row, s in zip(got, t):
        d = dt.datetime.fromtimestamp(int(s), dt.timezone.utc)
        assert tuple(row) == (d.second, d.minute, d.hour, d.day, d.month,
                              (d.weekday() + 1) % 7)


def test_cron_due_on_every_second_of_a_span():
    t = np.arange(1709160000, 1709160000 + 3 * 3600 + 7)   # across a leap day
    for spec in ("*/7 * * * * *", "0 * * * * *", "15,45 * * * * *",
                 "3 3 * * * *", "*/2 * 9-17 * * Mon-Fri", "30 */2 * * * *",
                 "0 0 * 29 2 ?", "*/10 * * ? * 0,6", "5-20/5 1 * * * *"):
        assert np.array_equal(reference.cron_due(spec, t), _brute(spec, t)), spec


def test_due_matrix_steps_every_row_from_its_anchor_and_reads_cron_rows():
    cfg = {"jobs": 64, "nodes": 32, "node_cap": 8}
    mix = {"exclusive_share": 0.5,
           "families": [{"share": 0.75, "every_s": [3, 11]},
                        {"share": 0.25, "cron": "*/20 * * * * *"}]}
    inp = gen.planner_inputs(cfg, mix, 2**40 + 3, "cpu")
    epochs = list(range(1753000000, 1753000100))
    got = reference.due_matrix(inp, epochs).numpy()
    for j in range(inp.jobs):
        if bool(inp.is_every[j]):
            a, p = int(inp.anchor[j]), int(inp.period[j])
            want = [(t - a) % p == 0 for t in epochs]
        else:
            want = [t % 20 == 0 for t in epochs]
        assert got[j].tolist() == want, j
    assert 0 < int(inp.is_every.sum()) < inp.jobs
