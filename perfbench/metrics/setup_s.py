"""Process start to the first timed batch or step."""


def read(rec):
    return rec.get('setup_s')
