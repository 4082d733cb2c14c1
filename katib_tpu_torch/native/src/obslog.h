/* C ABI for the native observation-log engine.
 *
 * TPU-native equivalent of the reference's DB-manager storage core
 * (pkg/db/v1beta1/common/kdb.go:23 — Report/Get/DeleteObservationLog over
 * one table observation_logs(trial_name, id, time, metric_name, value)),
 * rebuilt as an in-process C++ append log: interned metric names, per-trial
 * insertion-ordered entry vectors, mutex-guarded for concurrent trial
 * runners.  Also hosts the TEXT metrics-line parser (the hot path of the
 * reference's file/stdout metrics-collector sidecar,
 * pkg/metricscollector/v1beta1/file-metricscollector/file-metricscollector.go:45).
 *
 * Query objects snapshot matching entries under the store lock, so readers
 * never see torn state; their pointers stay valid until kt_query_free.
 */
#ifndef KATIB_TPU_OBSLOG_H
#define KATIB_TPU_OBSLOG_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* kt_store_t;
typedef void* kt_query_t;

/* -- store ------------------------------------------------------------- */
kt_store_t kt_store_new(void);
void kt_store_free(kt_store_t s);

void kt_store_report(kt_store_t s, const char* trial, const char* metric,
                     double value, double ts, int64_t step);
void kt_store_report_batch(kt_store_t s, const char* trial, int32_t n,
                           const char** metrics, const double* values,
                           const double* ts, const int64_t* steps);

/* metric == NULL or "" -> all metrics, in report order */
kt_query_t kt_store_get(kt_store_t s, const char* trial, const char* metric);
void kt_store_delete(kt_store_t s, const char* trial);
int64_t kt_store_total(kt_store_t s);
/* query whose names are the trial names, in first-report order */
kt_query_t kt_store_trial_names(kt_store_t s);

/* -- query accessors ---------------------------------------------------- */
int32_t kt_query_len(kt_query_t q);
/* '\n'-joined names, built lazily, owned by the query */
const char* kt_query_names_blob(kt_query_t q);
void kt_query_values(kt_query_t q, double* out);
void kt_query_timestamps(kt_query_t q, double* out);
void kt_query_steps(kt_query_t q, int64_t* out);
void kt_query_free(kt_query_t q);

/* -- TEXT metrics parser ------------------------------------------------ */
/* Parse newline-separated log lines for `name=value` pairs where name is in
 * the '\n'-separated tracked set; leading RFC3339 token becomes the
 * timestamp.  Semantics match the reference default filter
 * ([\w|-]+)\s*=\s*([+-]?float). Returns a query (step = -1). */
kt_query_t kt_parse_text(const char* text, const char* tracked_names);

#ifdef __cplusplus
}
#endif

#endif /* KATIB_TPU_OBSLOG_H */
