"""Test support shipped with the port: fault injection
(``testing/faults.py``) lives here so a server can run a chaos plan from
``PILOSA_FAULTS`` without test frameworks in the production tree."""
