"""How each kind of system a configuration names (its `system` key) is
built (`build`), counted (`counters`) and checked (`Check`, the reference's
side): one file a kind, found by that name. The window serves through the
built program's `serve_stream`."""
