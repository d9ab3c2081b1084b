"""Every token that arrived on the host in the window (first tokens
included), over the window's length in seconds."""


def read(rec: dict):
    if "tokens" not in rec:
        return None
    return rec["tokens"] / rec["window_s"]
