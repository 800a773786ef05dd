"""``traverse_host_rounds``: the mean, over the server's ``execute`` spans
in the window, of the ``host_rounds`` summed over the ``traverse`` spans
under each: the traversal rounds of a request that each ended in the host
waiting on the device.  None where the program records no ``traverse``
span."""

from tadoc_bench.readers import stage_spans


def read(run):
    per_exec, seen = [], False
    for ex in stage_spans(run, "execute"):
        rounds = [s.attrs.get("host_rounds", 0) for s in ex.walk()
                  if s.name == "traverse"]
        seen = seen or bool(rounds)
        per_exec.append(sum(rounds))
    if not seen:
        return None
    return sum(per_exec) / len(per_exec)
