"""Entries: the program's call that a cell's window drives.

``Entry(config, params, device)`` builds the program's objects from the
configuration (and fails where the program's settings differ from it);
``install(hooks, records, spans)`` wraps the program's module attributes
to record what each layer returns and to time it in a traced run;
``call(iq)`` decodes one batch; ``final(out)`` is the batch's result an
item, in the check's form; ``observe(records)`` the layers' outputs in the
reference's record types; ``bp_calls(records)`` the BP launches' inputs
(code name, LLRs, iterations); ``release()`` frees the program's state.
"""
