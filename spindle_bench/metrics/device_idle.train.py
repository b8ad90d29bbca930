"""Share of a call's wall with no operation running on the device."""

from yardstick import device


def read(run):
    return device.idle_percent(run)
