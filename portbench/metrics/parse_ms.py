"""The parse's wall an instance, in milliseconds: the program's
``ccvm.parse`` spans (the file read, the native tokenizer, the
negation), a part of what ``load_ms`` times from outside."""

from portbench import spans


def read(run):
    return spans.per_instance(run, spans.ms(spans.of_window(run), "ccvm.parse"))
