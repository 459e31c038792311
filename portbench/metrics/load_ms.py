"""Mean host milliseconds per instance loaded in the window: the port's
``ProblemInstance(file_path=...)`` and ``scale_coefs``, timed by the
benchmark around those calls."""


def read(run):
    spans = run.load_spans
    return 1e3 * sum(spans) / len(spans) if spans else None
