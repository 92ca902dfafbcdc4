"""The whole view's share of the card's peak: the least time the card
could take for a view's work (`counts.view_terms`, the mean over the
sampled views) over the measured `render_ms_per_view`, in %."""


def read(run):
    least = run.work.get("view_least_s")
    ms = run.e2e.get("render_ms_per_view")
    if run.driver != "render" or not least or not ms:
        return None
    return 100.0 * least / (ms * 1e-3)
