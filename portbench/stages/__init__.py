"""Program stages that a traffic mix can drive, one module each, found by
the traffic file's ``stage`` name.  Each module's ``Stage(inputs, device)``
sets the stage up, ``run(window)`` runs it once through the window's
wrappers, and ``release()`` drops what it holds on the device."""
