"""The port's step builders (ROADMAP queue 1 item 13): the serving half of
``repro.train.step``. Importing this package imports none of its
modules."""
