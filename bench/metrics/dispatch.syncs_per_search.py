"""Host waits on the device a search makes: the program's ``sync.*``
spans (the upload, the select's overflow read, the three copies back)
over the span slice's calls."""
from bench.lib import spans


def read(run):
    return spans.spans_per_call(run, "sync.")
