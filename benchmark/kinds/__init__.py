"""The load generators, one module a kind of traffic: ``<kind>.py`` holds the
class ``Load`` that every traffic file naming ``"kind": "<kind>"`` is run
by (``benchmark.drive.kind``).  A new kind is a new module here."""
