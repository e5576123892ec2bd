"""Device milliseconds per batch of both preprocessings (the subject's and the image tower's), by CUDA events."""


def read(run):
    spans = run.spans.device_ms()
    subject, fm = spans.get("subject_preprocess"), spans.get("fm_preprocess")
    if not subject or not fm or len(subject) != len(fm):
        return None
    return (sum(subject) + sum(fm)) / len(subject)
