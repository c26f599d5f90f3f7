"""Session state of the port: so far only the system-variable registry
(session/vars.py), which the planner's `@@x` constants read. The Session
itself comes with the front door's last step (ROADMAP Queue 1, item 4.4).
"""
