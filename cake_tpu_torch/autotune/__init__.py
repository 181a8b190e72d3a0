"""The autotune plane of the port: only the speculative gamma tuner
(autotune/spec.py) so far; the controller, its policy table and the
live reconfiguration are ROADMAP A7b."""
