"""Run one program builder in both packages: ``paddle_tpu`` (the reference)
and ``paddle_tpu_torch`` on the host, the port's scope taking the
reference's startup values by name, so random initializers (whose draws
differ between the packages) do not part the two runs.

The control-flow and seq2seq tests use it::

    got = run_both(lambda pkg: ([out], {"x": xv}))
    np.testing.assert_allclose(got["port"][0][0], got["ref"][0][0])
"""

import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu_torch import framework as port_framework

PKGS = (("ref", pt, ref_framework), ("port", ptt, port_framework))


def executor(pkg):
    """The reference's executor, or the port's on the host."""
    return ptt.Executor(ptt.CPUPlace()) if pkg is ptt else pt.Executor()


def startup_state(startup, scope):
    """The persistables a startup program made: name -> numpy array."""
    return {n: np.array(scope.find_var(n))
            for n, v in startup.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def run_both(build, steps=1, between=None, pin=None):
    """``build(pkg) -> (fetch_list, feed)`` in fresh programs, scope and
    names of each package; the startup runs, then the main program
    ``steps`` times.  ``pin(state)`` may change the reference's startup
    values (name -> array) before both packages take them.
    ``between(tag)`` runs after each package's runs (a capture of its
    output, say).  Returns ``{"ref": [fetches of each step], "port":
    [...]}``, each fetch a numpy array."""
    results, carried = {}, None
    for tag, pkg, fw in PKGS:
        main, startup, scope = pkg.Program(), pkg.Program(), fw.Scope()
        with fw.unique_name.guard(), pkg.program_guard(main, startup), \
                fw.scope_guard(scope):
            fetch, feed = build(pkg)
            exe = executor(pkg)
            exe.run(startup, scope=scope)
            if carried is None:
                carried = startup_state(startup, scope)
                if pin is not None:
                    pin(carried)
            for n, v in carried.items():
                scope.set_var(n, v)
            results[tag] = [[np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)]
                for _ in range(steps)]
        if between is not None:
            between(tag)
    return results
