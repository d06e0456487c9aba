"""One module a kind of entry the window drives, found by the ``entry``
key of a traffic mix: ``perfbench/entries/<entry>.py`` defines ``Runner``."""
