"""wire-coherence fixture (Python side): a three-flag vocabulary whose
receive surface silently drops one declared flag.  The C++ half of the
fixture (``_broken_wire.cpp``) desyncs kFlagNormal and loses the
non-NORMAL fallback route.  Never imported by runtime code."""

FLAG_NORMAL = 0
FLAG_DECISION = 4
FLAG_NACK = 10
FLAG_BATCH = 0xB7  # container flag: split natively, no Python branch


class BrokenReceiver:
    """Declared to handle NORMAL/DECISION/NACK; dispatches only two."""

    def on_frame(self, tag, payload):  # lint: wire-coherence/dispatch-gap
        if tag.flag == FLAG_NORMAL:
            return ("data", payload)
        if tag.flag == FLAG_DECISION:
            return ("decision", payload)
        return None  # FLAG_NACK falls through undetected
