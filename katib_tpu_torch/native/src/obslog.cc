// Native observation-log engine + TEXT metrics parser.  See obslog.h.

#include "obslog.h"

#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  int32_t name_id;
  double value;
  double ts;
  int64_t step;
};

struct Store {
  std::mutex mu;
  std::vector<std::string> names;  // id -> metric name
  std::unordered_map<std::string, int32_t> name_ids;
  std::unordered_map<std::string, std::vector<Entry>> trials;
  std::vector<std::string> trial_order;
  int64_t total = 0;

  int32_t intern(const std::string& name) {
    auto it = name_ids.find(name);
    if (it != name_ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(names.size());
    names.push_back(name);
    name_ids.emplace(name, id);
    return id;
  }
};

struct Query {
  std::vector<std::string> names;
  std::vector<double> values;
  std::vector<double> ts;
  std::vector<int64_t> steps;
  std::string blob;
  bool blob_built = false;
};

Store* as_store(kt_store_t s) { return static_cast<Store*>(s); }
Query* as_query(kt_query_t q) { return static_cast<Query*>(q); }

}  // namespace

extern "C" {

kt_store_t kt_store_new(void) { return new Store(); }

void kt_store_free(kt_store_t s) { delete as_store(s); }

static void report_locked(Store* st, const char* trial, const char* metric,
                          double value, double ts, int64_t step) {
  auto it = st->trials.find(trial);
  if (it == st->trials.end()) {
    it = st->trials.emplace(trial, std::vector<Entry>()).first;
    st->trial_order.push_back(trial);
  }
  it->second.push_back(Entry{st->intern(metric), value, ts, step});
  st->total++;
}

void kt_store_report(kt_store_t s, const char* trial, const char* metric,
                     double value, double ts, int64_t step) {
  Store* st = as_store(s);
  std::lock_guard<std::mutex> lk(st->mu);
  report_locked(st, trial, metric, value, ts, step);
}

void kt_store_report_batch(kt_store_t s, const char* trial, int32_t n,
                           const char** metrics, const double* values,
                           const double* ts, const int64_t* steps) {
  Store* st = as_store(s);
  std::lock_guard<std::mutex> lk(st->mu);
  for (int32_t i = 0; i < n; ++i)
    report_locked(st, trial, metrics[i], values[i], ts[i], steps[i]);
}

kt_query_t kt_store_get(kt_store_t s, const char* trial, const char* metric) {
  Store* st = as_store(s);
  Query* q = new Query();
  bool filter = metric != nullptr && metric[0] != '\0';
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->trials.find(trial);
  if (it == st->trials.end()) return q;
  int32_t want = -1;
  if (filter) {
    auto nit = st->name_ids.find(metric);
    if (nit == st->name_ids.end()) return q;
    want = nit->second;
  }
  for (const Entry& e : it->second) {
    if (filter && e.name_id != want) continue;
    q->names.push_back(st->names[e.name_id]);
    q->values.push_back(e.value);
    q->ts.push_back(e.ts);
    q->steps.push_back(e.step);
  }
  return q;
}

void kt_store_delete(kt_store_t s, const char* trial) {
  Store* st = as_store(s);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->trials.find(trial);
  if (it == st->trials.end()) return;
  st->total -= static_cast<int64_t>(it->second.size());
  st->trials.erase(it);
  for (auto t = st->trial_order.begin(); t != st->trial_order.end(); ++t) {
    if (*t == trial) {
      st->trial_order.erase(t);
      break;
    }
  }
}

int64_t kt_store_total(kt_store_t s) {
  Store* st = as_store(s);
  std::lock_guard<std::mutex> lk(st->mu);
  return st->total;
}

kt_query_t kt_store_trial_names(kt_store_t s) {
  Store* st = as_store(s);
  Query* q = new Query();
  std::lock_guard<std::mutex> lk(st->mu);
  for (const std::string& t : st->trial_order) {
    q->names.push_back(t);
    q->values.push_back(0.0);
    q->ts.push_back(0.0);
    q->steps.push_back(0);
  }
  return q;
}

int32_t kt_query_len(kt_query_t q) {
  return static_cast<int32_t>(as_query(q)->names.size());
}

const char* kt_query_names_blob(kt_query_t q) {
  Query* qq = as_query(q);
  if (!qq->blob_built) {
    size_t total = 0;
    for (const std::string& n : qq->names) total += n.size() + 1;
    qq->blob.reserve(total);
    for (size_t i = 0; i < qq->names.size(); ++i) {
      if (i) qq->blob.push_back('\n');
      qq->blob += qq->names[i];
    }
    qq->blob_built = true;
  }
  return qq->blob.c_str();
}

void kt_query_values(kt_query_t q, double* out) {
  Query* qq = as_query(q);
  std::memcpy(out, qq->values.data(), qq->values.size() * sizeof(double));
}

void kt_query_timestamps(kt_query_t q, double* out) {
  Query* qq = as_query(q);
  std::memcpy(out, qq->ts.data(), qq->ts.size() * sizeof(double));
}

void kt_query_steps(kt_query_t q, int64_t* out) {
  Query* qq = as_query(q);
  std::memcpy(out, qq->steps.data(), qq->steps.size() * sizeof(int64_t));
}

void kt_query_free(kt_query_t q) { delete as_query(q); }

}  // extern "C"

// ---------------------------------------------------------------------------
// TEXT metrics parser
// ---------------------------------------------------------------------------

namespace {

bool is_wordish(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c == '|' || c == '-';
}

// Parse the float subset the reference filter accepts:
// [+-]? digits* (.digits+)? ([eE][+-]?digits+)? with >=1 mantissa digit.
// Returns chars consumed (0 = no match) and writes the value.
size_t parse_float(const char* p, const char* end, double* out) {
  const char* q = p;
  if (q < end && (*q == '+' || *q == '-')) q++;
  const char* mant = q;
  while (q < end && *q >= '0' && *q <= '9') q++;
  bool digits = q > mant;
  if (q < end && *q == '.') {
    const char* frac = q + 1;
    const char* r = frac;
    while (r < end && *r >= '0' && *r <= '9') r++;
    if (r > frac) {
      q = r;
      digits = true;
    }
  }
  if (!digits) return 0;
  if (q < end && (*q == 'e' || *q == 'E')) {
    const char* e = q + 1;
    if (e < end && (*e == '+' || *e == '-')) e++;
    const char* ed = e;
    while (e < end && *e >= '0' && *e <= '9') e++;
    if (e > ed) q = e;
  }
  std::string tok(p, q - p);
  *out = std::strtod(tok.c_str(), nullptr);
  return static_cast<size_t>(q - p);
}

// RFC3339 subset: YYYY-MM-DDThh:mm:ss[.frac](Z|±hh:mm).  Returns true and
// writes the epoch timestamp; matches the Python datetime.fromisoformat path
// for the full timestamp format log lines actually carry.
bool parse_rfc3339(const std::string& tok, double* out) {
  int y, mo, d, h, mi, s, n = 0;
  if (std::sscanf(tok.c_str(), "%4d-%2d-%2dT%2d:%2d:%2d%n", &y, &mo, &d, &h,
                  &mi, &s, &n) != 6 ||
      n < 19)
    return false;
  size_t i = static_cast<size_t>(n);
  double frac = 0.0;
  if (i < tok.size() && tok[i] == '.') {
    size_t fs = ++i;
    while (i < tok.size() && tok[i] >= '0' && tok[i] <= '9') i++;
    if (i == fs) return false;
    frac = std::strtod(("0." + tok.substr(fs, i - fs)).c_str(), nullptr);
  }
  long offset = 0;
  if (i < tok.size() && (tok[i] == 'Z' || tok[i] == 'z')) {
    i++;
  } else if (i < tok.size() && (tok[i] == '+' || tok[i] == '-')) {
    int oh, om;
    if (std::sscanf(tok.c_str() + i + 1, "%2d:%2d", &oh, &om) != 2)
      return false;
    offset = (oh * 3600L + om * 60L) * (tok[i] == '-' ? -1 : 1);
    i += 6;
  } else {
    return false;  // naive timestamps are ambiguous; treat as no timestamp
  }
  if (i != tok.size()) return false;
  std::tm tm{};
  tm.tm_year = y - 1900;
  tm.tm_mon = mo - 1;
  tm.tm_mday = d;
  tm.tm_hour = h;
  tm.tm_min = mi;
  tm.tm_sec = s;
  *out = static_cast<double>(timegm(&tm)) + frac - static_cast<double>(offset);
  return true;
}

}  // namespace

extern "C" kt_query_t kt_parse_text(const char* text,
                                    const char* tracked_names) {
  Query* q = new Query();
  std::unordered_map<std::string, bool> tracked;
  {
    const char* p = tracked_names;
    while (*p) {
      const char* nl = std::strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
      if (len) tracked.emplace(std::string(p, len), true);
      if (!nl) break;
      p = nl + 1;
    }
  }

  const char* line = text;
  while (*line) {
    const char* nl = std::strchr(line, '\n');
    const char* end = nl ? nl : line + std::strlen(line);

    // leading whitespace-delimited token as RFC3339 timestamp
    double ts = 0.0;
    const char* sp = line;
    while (sp < end && *sp != ' ') sp++;
    if (sp > line) parse_rfc3339(std::string(line, sp - line), &ts);

    const char* p = line;
    while (p < end) {
      if (!is_wordish(*p)) {
        p++;
        continue;
      }
      const char* name_start = p;
      while (p < end && is_wordish(*p)) p++;
      std::string name(name_start, p - name_start);
      const char* after = p;
      while (after < end && (*after == ' ' || *after == '\t')) after++;
      if (after >= end || *after != '=') continue;  // resume after the token
      after++;
      while (after < end && (*after == ' ' || *after == '\t')) after++;
      double value;
      size_t used = parse_float(after, end, &value);
      if (used == 0) continue;
      p = after + used;
      if (tracked.find(name) == tracked.end()) continue;
      q->names.push_back(std::move(name));
      q->values.push_back(value);
      q->ts.push_back(ts);
      q->steps.push_back(-1);
    }
    if (!nl) break;
    line = nl + 1;
  }
  return q;
}
