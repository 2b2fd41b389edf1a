"""host_reads_per_job (reads; the entry, program counter): the program's
`host_reads` over the traced window's jobs: the reads of a device tensor
on the host through `utils/profiling.py::to_host`, each a synchronizing
copy. Implicit syncs (an `.item()`, a solver's error check) are not
counted."""

from benchlib import program


def read(rec):
    prog = program.recorder(rec)
    if prog is None or not prog.counters.get("host_reads"):
        return None
    return program.per_job(rec, prog.counters["host_reads"])
