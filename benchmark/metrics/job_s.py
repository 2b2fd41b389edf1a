"""job_s (s, host clock): the window's wall time over the whole jobs it
completed. The window runs jobs back to back, starts none once --seconds
have passed, and ends with the last job and a synchronize."""


def read(rec):
    return rec["window_s"] / rec["jobs"] if rec["jobs"] else None
