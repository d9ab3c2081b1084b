"""The tokens of every optimizer step completed in the window, over the
window's length in seconds."""


def read(rec: dict):
    if "train_tokens" not in rec:
        return None
    return rec["train_tokens"] / rec["window_s"]
